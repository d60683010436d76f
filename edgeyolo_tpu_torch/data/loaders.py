"""Inference sources (edgeyolo_tpu/data/loaders.py).

`load_inference_source(source)` returns `(loader, SourceTypes)`; a loader is
an iterator of (name, HWC RGB uint8 frame):
- a file, a directory (recursively), a glob or a list of paths: still images
  (named by their path) and video files (frames named `path:i`);
- one HWC array or a list of arrays (image0, image1, ...), a (B, H, W, 3)
  array or tensor (tensor0, tensor1, ...);
- any other iterable of frames: `FrameStream` (stream0:i);
- an `http://` or `https://` MJPEG camera (multipart/x-mixed-replace):
  `open_mjpeg_http` behind a `FrameStream` (url:i);
- `rtsp://`, `rtmp://` or a webcam index: `LoadStreams`, which opens each
  `|`-separated source through the video-decoder registry.

Video files decode through `VIDEO_DECODERS`: the built-in one reads MJPEG
AVI on the port's own JPEG codec. JAX's cv2, PIL-animated and imageio
decoders are not here (none of those packages is a dependency of the port),
so mp4, animated GIF/WebP/TIFF, RTSP and webcams raise NotImplementedError
unless a decoder is registered with `register_video_decoder`, or the frames
are handed over as an iterable (`FrameStream`). A frame that fails to decode
raises; nothing is skipped.
"""

from __future__ import annotations

import glob
import queue as queue_mod
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from edgeyolo_tpu_torch.data.imageio import decode_jpeg, load_image_rgb
from edgeyolo_tpu_torch.utils import LOGGER

IMG_EXTS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm", ".gif"}
SOI, EOI = b"\xff\xd8\xff", b"\xff\xd9"


@dataclass
class SourceTypes:
    stream: bool = False
    screenshot: bool = False
    from_img: bool = False
    tensor: bool = False


VIDEO_DECODERS: list = []


def register_video_decoder(fn, prepend: bool = False):
    """Register a decoder: fn(path) returns an iterator of HWC RGB uint8
    frames, or None if it cannot handle the source."""
    if prepend:
        VIDEO_DECODERS.insert(0, fn)
    else:
        VIDEO_DECODERS.append(fn)
    return fn


def _jpeg_frames(data: bytes, name: str):
    """Each SOI..EOI blob of `data`, decoded (JAX's scan: the first EOI after
    each SOI). A blob that does not decode, or an SOI with no EOI, raises."""
    i = 0
    while True:
        s = data.find(SOI, i)
        if s < 0:
            return
        e = data.find(EOI, s)
        if e < 0:
            raise ValueError(f"{name}: truncated JPEG frame at byte {s}")
        try:
            yield decode_jpeg(data[s:e + 2])
        except ValueError as err:
            raise ValueError(f"{name}: JPEG frame at byte {s}: {err}") from None
        i = e + 2


def _mjpeg_avi_decoder(path: str):
    """MJPEG in AVI: the movi chunk is concatenated JPEGs, decoded on the
    port's codec (JAX `_mjpeg_avi_decoder`, which decodes with PIL)."""
    p = Path(path)
    if p.suffix.lower() != ".avi" or not p.is_file():
        return None
    data = p.read_bytes()
    if b"MJPG" not in data[:4096] and b"mjpg" not in data[:4096]:
        return None
    return _jpeg_frames(data, str(p))


VIDEO_DECODERS.append(_mjpeg_avi_decoder)


def open_video(path: str):
    """A video source -> frame iterator, by the first registered decoder that takes it."""
    for dec in VIDEO_DECODERS:
        it = dec(str(path))
        if it is not None:
            return it
    raise NotImplementedError(
        f"no registered decoder handles '{path}'. The built-in decoder reads MJPEG AVI; "
        "register_video_decoder() plugs in others (mp4, animated GIF/WebP/TIFF, RTSP, "
        "webcams), or pass the frames as an iterable (FrameStream buffers it).")


class LoadVideo:
    """One video file's frames, named `path:i`; vid_stride keeps frame 0 and
    every stride-th frame after it."""

    def __init__(self, path: str, vid_stride: int = 1):
        self.path = str(path)
        self.vid_stride = max(1, int(vid_stride))

    def __iter__(self):
        for i, frame in enumerate(open_video(self.path)):
            if i % self.vid_stride:
                continue
            yield f"{self.path}:{i}", np.asarray(frame)


class LoadImages:
    """Image and video files from a file, a directory (recursively), a glob
    or a list of paths: the images first, then each video's frames."""

    def __init__(self, source, batch: int = 1, vid_stride: int = 1):
        paths = source if isinstance(source, (list, tuple)) else [source]
        files: list[Path] = []
        videos: list[Path] = []
        for s in map(str, paths):
            p = Path(s)
            if p.is_dir():
                files += sorted(x for x in p.rglob("*.*") if x.suffix.lower() in IMG_EXTS)
                videos += sorted(x for x in p.rglob("*.*") if x.suffix.lower() in VID_EXTS)
            elif "*" in s:
                files += [Path(f) for f in sorted(glob.glob(s)) if Path(f).suffix.lower() in IMG_EXTS]
            elif p.is_file():
                (videos if p.suffix.lower() in VID_EXTS else files).append(p)
            else:
                raise FileNotFoundError(f"source not found: {s}")
        self.files, self.videos = files, videos
        self.batch, self.vid_stride = batch, vid_stride

    def __len__(self):
        return len(self.files) + len(self.videos)

    def __iter__(self):
        for f in self.files:
            yield str(f), load_image_rgb(f)
        for v in self.videos:
            yield from LoadVideo(str(v), vid_stride=self.vid_stride)


class LoadArrays:
    """In-memory HWC uint8 frames (JAX LoadPilAndNumpy and LoadTensor)."""

    def __init__(self, imgs, prefix: str = "image"):
        self.items, self.prefix = list(imgs), prefix

    def __iter__(self):
        for i, im in enumerate(self.items):
            yield f"{self.prefix}{i}", np.asarray(im)


class FrameStream:
    """A reader thread and a bounded queue over any iterable of frames. A
    full queue makes the reader wait up to a second, then drop the oldest
    frame. An exception in the iterable is raised to the consumer."""

    def __init__(self, frame_iter, buffer: int = 8, name: str = "stream0"):
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=buffer)
        self.name = name
        self.done = False
        self.error: Exception | None = None

        def pump():
            try:
                for fr in frame_iter:
                    if self.done:
                        break
                    try:
                        self.q.put(fr, timeout=1.0)
                    except queue_mod.Full:  # drop the oldest
                        try:
                            self.q.get_nowait()
                        except queue_mod.Empty:
                            pass
                        self.q.put(fr)
            except Exception as e:  # noqa: BLE001 - raised to the consumer by __iter__
                self.error = e
            self.done = True

        self.thread = threading.Thread(target=pump, daemon=True)
        self.thread.start()

    def __iter__(self):
        i = 0
        while not (self.done and self.q.empty()):
            try:
                fr = self.q.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            yield f"{self.name}:{i}", np.asarray(fr)
            i += 1
        if self.error is not None:
            raise self.error

    def close(self):
        self.done = True


def open_mjpeg_http(url: str, timeout: float = 5.0):
    """Frames of an MJPEG-over-HTTP camera: a multipart/x-mixed-replace
    response on stdlib http.client, each JPEG part decoded on the port's
    codec. Parts are cut at SOI..EOI, which also survives cameras with
    sloppy part headers. A response of another type raises
    NotImplementedError."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    conn_cls = http.client.HTTPSConnection if u.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(u.hostname, u.port or (443 if u.scheme == "https" else 80), timeout=timeout)
    conn.request("GET", (u.path or "/") + (f"?{u.query}" if u.query else ""))
    resp = conn.getresponse()
    ctype = resp.getheader("Content-Type", "")
    if "multipart/x-mixed-replace" not in ctype:
        conn.close()
        raise NotImplementedError(
            f"'{url}' is not an MJPEG stream (Content-Type: {ctype or 'none'}); only "
            "multipart/x-mixed-replace HTTP cameras are read (register_video_decoder or "
            "FrameStream for others)")

    def gen():
        buf = b""
        try:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while True:
                    s = buf.find(SOI)
                    if s < 0:  # keep a tail that may hold a split marker
                        buf = buf[-4096:] if len(buf) > 65536 else buf
                        break
                    e = buf.find(EOI, s)
                    if e < 0:
                        break
                    blob, buf = buf[s:e + 2], buf[e + 2:]
                    try:
                        yield decode_jpeg(blob)
                    except ValueError as err:
                        raise ValueError(f"{url}: {err}") from None
            if buf.find(SOI) >= 0:
                raise ValueError(f"{url}: the stream ended inside a JPEG frame")
        finally:
            conn.close()

    return gen()


def open_stream(src: str):
    """One live source: an HTTP MJPEG camera, or whatever a registered
    decoder opens (a video file, an RTSP URL or a webcam index)."""
    if src.startswith(("http://", "https://")):
        return open_mjpeg_http(src)
    return open_video(src)


class LoadStreams:
    """Live sources (a list, or one string of `|`-separated sources), one
    reader thread and bounded queue each; iteration takes one frame from
    each open source in turn until every source ends. Frames are named by
    their source. buffer=False (`stream_buffer`'s default) drops the oldest
    queued frame when the queue is full: the latest frame wins. buffer=True
    makes the reader wait, so every frame is delivered. A reader's error is
    raised to the consumer."""

    def __init__(self, sources, buffer_size: int = 30, buffer: bool = False):
        self.sources = sources.split("|") if isinstance(sources, str) else [str(s) for s in sources]
        self.buffer = bool(buffer)
        self.running = True
        self._queues: list[queue_mod.Queue] = []
        self._errors: list[Exception | None] = []
        frames = [open_stream(s) for s in self.sources]  # an unopenable source raises here
        for i, it in enumerate(frames):
            q: queue_mod.Queue = queue_mod.Queue(maxsize=buffer_size)
            self._queues.append(q)
            self._errors.append(None)
            threading.Thread(target=self._reader, args=(it, q, i), daemon=True).start()
        LOGGER.info(f"LoadStreams: {len(self.sources)} source(s) open")

    def _put(self, q: queue_mod.Queue, item) -> None:
        if self.buffer:  # wait for the consumer, waking so that close() can stop it
            while self.running:
                try:
                    q.put(item, timeout=0.25)
                    return
                except queue_mod.Full:
                    continue
            return
        if q.full():
            try:
                q.get_nowait()
            except queue_mod.Empty:
                pass
        try:
            q.put_nowait(item)
        except queue_mod.Full:
            pass

    def _reader(self, frames, q: queue_mod.Queue, i: int):
        try:
            for frame in frames:
                if not self.running:
                    return
                self._put(q, np.ascontiguousarray(frame))
        except Exception as e:  # noqa: BLE001 - raised to the consumer by __iter__
            self._errors[i] = e
        self._put(q, None)  # end of the stream

    def __iter__(self):
        live = [True] * len(self._queues)
        while any(live):
            for i, q in enumerate(self._queues):
                if not live[i]:
                    continue
                frame = q.get()
                if frame is None:
                    live[i] = False
                    if self._errors[i] is not None:
                        self.close()
                        raise self._errors[i]
                    continue
                yield self.sources[i], frame

    def close(self):
        self.running = False

    def __del__(self):
        self.close()


def load_inference_source(source, batch: int = 1, vid_stride: int = 1,
                          stream_buffer: bool = False):
    """Any source -> ((name, frame) iterator, SourceTypes)."""
    st = SourceTypes()
    if isinstance(source, torch.Tensor):
        source = source.detach().cpu().numpy()
    if isinstance(source, np.ndarray) and source.ndim == 4:
        st.tensor = True
        return LoadArrays(source, "tensor"), st
    if isinstance(source, np.ndarray):
        st.from_img = True
        return LoadArrays([source]), st
    if isinstance(source, (list, tuple)) and source and isinstance(source[0], np.ndarray):
        st.from_img = True
        return LoadArrays(source), st
    if isinstance(source, (list, tuple)):
        return LoadImages(source, batch, vid_stride=vid_stride), st
    if hasattr(source, "__iter__") and not isinstance(source, (str, Path)):
        st.stream = True
        return FrameStream(source), st
    if not isinstance(source, (str, Path)):
        raise TypeError(f"unsupported source type {type(source).__name__}")
    s = str(source)
    if s.startswith(("http://", "https://")):
        st.stream = True
        return FrameStream(open_mjpeg_http(s), name=s), st
    if s.startswith(("rtsp://", "rtmp://")) or s.isnumeric():
        st.stream = True
        return LoadStreams(s, buffer=stream_buffer), st
    if s == "screen":
        raise NotImplementedError("screen capture is not a source of the port")
    return LoadImages(source, batch, vid_stride=vid_stride), st
