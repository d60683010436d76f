"""BYTETracker: two-stage (high/low confidence) association over Kalman tracks
(edgeyolo_tpu/trackers/byte_tracker.py).

The STrack state machine and the update loop: Kalman multi_predict, a first
association of the high-confidence detections by IoU and the Hungarian
method, a second of the unmatched tracks with the low-confidence ones,
re-activation of lost tracks, new tracks, pruning. Host numpy and scipy;
the detections arrive from the device NMS. Track ids come from a class-level
counter (`STrack.reset_id`), reset by each new tracker.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

from edgeyolo_tpu_torch.metrics.metrics import _box_iou_np
from edgeyolo_tpu_torch.trackers.kalman import KalmanFilterXYAH


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


def linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian assignment with cost gate. Returns (matches, u_rows, u_cols)."""
    if cost.size == 0:
        return np.empty((0, 2), int), np.arange(cost.shape[0]), np.arange(cost.shape[1])
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    matches = [[r, c] for r, c in zip(rows, cols) if cost[r, c] <= thresh]
    matched_r = {m[0] for m in matches}
    matched_c = {m[1] for m in matches}
    u_rows = np.asarray([r for r in range(cost.shape[0]) if r not in matched_r], int)
    u_cols = np.asarray([c for c in range(cost.shape[1]) if c not in matched_c], int)
    return np.asarray(matches, int).reshape(-1, 2), u_rows, u_cols


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU cost between track/detection xyxy boxes."""
    a = np.asarray([t.xyxy for t in atracks], np.float32).reshape(-1, 4)
    b = np.asarray([t.xyxy for t in btracks], np.float32).reshape(-1, 4)
    if len(a) == 0 or len(b) == 0:
        return np.ones((len(a), len(b)), np.float32)
    return 1.0 - _box_iou_np(a, b)


def fuse_score(cost: np.ndarray, detections) -> np.ndarray:
    """Fuse detection confidence into the IoU cost (reference matching.py)."""
    if cost.size == 0:
        return cost
    iou_sim = 1 - cost
    det_scores = np.asarray([d.score for d in detections])
    fused = iou_sim * det_scores[None]
    return 1 - fused


class STrack:
    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xywh, score, cls):
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = cls
        self.track_id = 0
        self.state = TrackState.New
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0
        self.idx = -1

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    # -- geometry ---------------------------------------------------------------
    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # cx, cy, a, h
        ret[2] *= ret[3]  # w = a*h
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        t = self.tlwh
        return np.asarray([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @property
    def xywh(self):
        t = self.tlwh
        return np.asarray([t[0] + t[2] / 2, t[1] + t[3] / 2, t[2], t[3]], np.float32)

    def _to_xyah(self, tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    # -- lifecycle ---------------------------------------------------------------
    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self._to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self):
        return self.frame_id

    @staticmethod
    def multi_predict(stracks):
        if not stracks:
            return
        means = np.stack([t.mean.copy() for t in stracks])
        covs = np.stack([t.covariance for t in stracks])
        for i, t in enumerate(stracks):
            if t.state != TrackState.Tracked:
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for i, t in enumerate(stracks):
            t.mean, t.covariance = means[i], covs[i]

    @staticmethod
    def multi_gmc(stracks, H=None):
        """Warp Kalman states by a 2x3 camera-motion matrix (reference
        byte_tracker.py STrack.multi_gmc: kron(eye(4), R) on mean/cov,
        translation added to the position entries)."""
        if not stracks or H is None:
            return
        R = np.asarray(H, np.float64)[:2, :2]
        R8 = np.kron(np.eye(4), R)
        t = np.asarray(H, np.float64)[:2, 2]
        for tr in stracks:
            if tr.mean is None:
                continue
            mean = R8 @ tr.mean
            mean[:2] += t
            tr.mean = mean
            tr.covariance = R8 @ tr.covariance @ R8.T


class BYTETracker:
    """Two-stage association tracker."""

    def __init__(self, args=None, frame_rate: int = 30, track_high_thresh=0.25,
                 track_low_thresh=0.1, new_track_thresh=0.25, track_buffer=30,
                 match_thresh=0.8, fuse_score_flag=True):
        if args is not None:
            track_high_thresh = getattr(args, "track_high_thresh", track_high_thresh)
            track_low_thresh = getattr(args, "track_low_thresh", track_low_thresh)
            new_track_thresh = getattr(args, "new_track_thresh", new_track_thresh)
            track_buffer = getattr(args, "track_buffer", track_buffer)
            match_thresh = getattr(args, "match_thresh", match_thresh)
            fuse_score_flag = getattr(args, "fuse_score", fuse_score_flag)
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_score = fuse_score_flag
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, dets, scores, cls):
        return [STrack(d, s, c) for d, s, c in zip(dets, scores, cls)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        if self.fuse_score:
            dists = fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        """KF predict for a track pool — overridable dispatch point (BOTSORT
        substitutes BOTrack's XYWH shared filter; reference byte_tracker.py
        BYTETracker.multi_predict / bot_sort.py override)."""
        STrack.multi_predict(tracks)

    def update(self, boxes_xyxy: np.ndarray, scores: np.ndarray, clss: np.ndarray,
               img: np.ndarray | None = None) -> np.ndarray:
        """One frame. Returns (N, 8) [x1,y1,x2,y2,track_id,score,cls,det_idx]
        rows for activated tracks (det_idx = the original detection row, used
        by track.py to re-index Results). `img` (HWC uint8) enables
        camera-motion compensation when the tracker carries a GMC estimator
        (BoT-SORT)."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        xywh = np.concatenate(
            [(boxes_xyxy[:, :2] + boxes_xyxy[:, 2:4]) / 2, boxes_xyxy[:, 2:4] - boxes_xyxy[:, :2]], 1
        ) if len(boxes_xyxy) else np.zeros((0, 4), np.float32)
        remain = scores >= self.track_high_thresh
        low = (scores > self.track_low_thresh) & (~remain)
        dets_high = self.init_track(xywh[remain], scores[remain], clss[remain])
        for i, t in zip(np.where(remain)[0], dets_high):
            t.idx = int(i)
        dets_low = self.init_track(xywh[low], scores[low], clss[low])
        for i, t in zip(np.where(low)[0], dets_low):
            t.idx = int(i)

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)

        # camera-motion compensation (BoT-SORT; reference bot_sort update)
        gmc = getattr(self, "gmc", None)
        if gmc is not None and img is not None:
            warp = gmc.apply(img)
            STrack.multi_gmc(strack_pool, warp)
            STrack.multi_gmc(unconfirmed, warp)

        # first association: high conf
        dists = self.get_dists(strack_pool, dets_high)
        matches, u_track, u_det = linear_assignment(dists, self.match_thresh)
        for it, idet in matches:
            t, d = strack_pool[it], dets_high[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)

        # second association: low conf vs remaining tracked
        r_tracks = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracks, dets_low)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            t, d = r_tracks[it], dets_low[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)
        for i in u_track2:
            t = r_tracks[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # unconfirmed tracks vs leftover high-conf dets
        left_high = [dets_high[i] for i in u_det]
        dists = self.get_dists(unconfirmed, left_high)
        matches, u_unconf, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(left_high[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            t = unconfirmed[i]
            t.mark_removed()
            removed.append(t)

        # new tracks
        for i in u_det2:
            t = left_high[i]
            if t.score >= self.new_track_thresh:
                t.activate(self.kalman_filter, self.frame_id)
                activated.append(t)

        # prune old lost
        for t in self.lost_stracks:
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [
            np.concatenate([t.xyxy, [t.track_id, t.score, t.cls, t.idx]])
            for t in self.tracked_stracks if t.is_activated
        ]
        return np.asarray(out, np.float32).reshape(-1, 8)

    def reset(self):
        self.tracked_stracks, self.lost_stracks, self.removed_stracks = [], [], []
        self.frame_id = 0
        self.kalman_filter = self.get_kalmanfilter()
        gmc = getattr(self, "gmc", None)
        if gmc is not None:
            gmc.reset()
        STrack.reset_id()


def joint_stracks(a, b):
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a, b):
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(a, b):
    dist = iou_distance(a, b)
    pairs = np.where(dist < 0.15)
    dup_a, dup_b = [], []
    for ia, ib in zip(*pairs):
        if a[ia].frame_id - a[ia].start_frame > b[ib].frame_id - b[ib].start_frame:
            dup_b.append(ib)
        else:
            dup_a.append(ia)
    return [t for i, t in enumerate(a) if i not in set(dup_a)], [t for i, t in enumerate(b) if i not in set(dup_b)]
