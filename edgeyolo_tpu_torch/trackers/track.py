"""Tracking over a Results stream (edgeyolo_tpu/trackers/track.py).

`make_tracker` builds a BYTETracker or BOTSORT from a name or a tracker YAML
(cfg/trackers/{bytetrack,botsort}.yaml, byte-identical copies of the JAX
package's, read by utils/yamlfile.py); `track_stream` updates it with each
frame's boxes and keeps the tracked ones, with their ids.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.trackers.byte_tracker import BYTETracker
from edgeyolo_tpu_torch.trackers.bot_sort import BOTSORT
from edgeyolo_tpu_torch.utils.yamlfile import yaml_load

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}


_CFG_KEYS = {
    "track_high_thresh", "track_low_thresh", "new_track_thresh", "track_buffer",
    "match_thresh", "proximity_thresh", "appearance_thresh", "with_reid", "gmc_method",
}


def make_tracker(cfg: str = "bytetrack", frame_rate: int = 30):
    """Build a tracker from a name or a tracker YAML (reference track.py:18-50
    reads cfg/trackers/{bytetrack,botsort}.yaml via check_yaml + IterableSimpleNamespace).

    Accepts "bytetrack"/"botsort", a packaged YAML name ("bytetrack.yaml"),
    or a filesystem path to a custom tracker YAML.
    """
    p = Path(str(cfg))
    if p.suffix != ".yaml" and str(cfg) in TRACKER_MAP:
        return TRACKER_MAP[str(cfg)](frame_rate=frame_rate)
    if not p.exists():
        packaged = Path(__file__).parent.parent / "cfg" / "trackers" / p.with_suffix(".yaml").name
        if packaged.exists():
            p = packaged
    if not p.exists():
        raise ValueError(f"unknown tracker '{cfg}'; expected one of {sorted(TRACKER_MAP)} "
                         f"or a tracker YAML path")
    d = yaml_load(p)
    ttype = d.get("tracker_type", p.stem)
    if ttype not in TRACKER_MAP:
        raise ValueError(f"tracker_type '{ttype}' not in {sorted(TRACKER_MAP)}")
    kw = {k: v for k, v in d.items() if k in _CFG_KEYS}
    if "fuse_score" in d:
        kw["fuse_score_flag"] = bool(d["fuse_score"])
    if ttype == "bytetrack":
        kw = {k: v for k, v in kw.items()
              if k not in ("proximity_thresh", "appearance_thresh", "with_reid", "gmc_method")}
    return TRACKER_MAP[ttype](frame_rate=frame_rate, **kw)


def track_stream(results_iter, tracker_cfg: str = "bytetrack", persist: bool = False,
                 frame_rate: int = 30, tracker=None):
    """Generator: annotate each Results with track ids (boxes gain id column
    semantics via filtering to tracked detections). Pass an existing tracker
    to keep id continuity across calls (reference persist=True semantics,
    track.py:18-50 reuses predictor.trackers between predict calls)."""
    tracker = tracker if tracker is not None else make_tracker(tracker_cfg, frame_rate)
    for res in results_iter:
        if res.boxes is None or len(res.boxes) == 0:
            res.track_ids = np.zeros((0,), np.int64)
            yield res
            continue
        b = res.boxes
        tracks = tracker.update(b.xyxy, b.conf, b.cls, img=res.orig_img)
        if len(tracks):
            idx = tracks[:, 7].astype(int)
            res = res[idx]
            # (N,7) [x1,y1,x2,y2,id,conf,cls] — Boxes.is_track / .id layout
            res.update(boxes=tracks[:, :7])
            res.track_ids = tracks[:, 4].astype(np.int64)
            res.boxes_tracked = tracks[:, :7]
        else:
            res = res[np.zeros((0,), int)]
            res.track_ids = np.zeros((0,), np.int64)
        yield res
