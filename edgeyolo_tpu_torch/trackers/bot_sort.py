"""BoT-SORT: BYTETracker with an XYWH Kalman filter, camera-motion
compensation and optional ReID feature fusion (edgeyolo_tpu/trackers/bot_sort.py).

BOTrack keeps an EMA of its appearance features; the cost fuses proximity
and appearance. `with_reid` is accepted as JAX accepts it: no embeddings
reach the tracker from `track_stream`, so the IoU cost decides. Motion
compensation is trackers/gmc.py's; pass the frame as
tracker.update(..., img=frame).
"""

from __future__ import annotations

import numpy as np

from edgeyolo_tpu_torch.trackers.byte_tracker import (
    BYTETracker,
    STrack,
    TrackState,
    fuse_score,
    iou_distance,
    linear_assignment,
)
from edgeyolo_tpu_torch.trackers.kalman import KalmanFilterXYWH


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat=None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.alpha = 0.9
        self.features: list[np.ndarray] = []
        self.feat_history = feat_history
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-12)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-12
        self.features.append(feat)
        if len(self.features) > self.feat_history:
            self.features.pop(0)

    def _to_xyah(self, tlwh):  # xywh filter state instead of xyah
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # cx, cy, w, h
        ret[:2] -= ret[2:] / 2
        return ret

    @staticmethod
    def multi_predict(stracks):
        if not stracks:
            return
        means = np.stack([t.mean.copy() for t in stracks])
        covs = np.stack([t.covariance for t in stracks])
        for i, t in enumerate(stracks):
            if t.state != TrackState.Tracked:
                means[i][6] = 0
                means[i][7] = 0
        means, covs = BOTrack.shared_kalman.multi_predict(means, covs)
        for i, t in enumerate(stracks):
            t.mean, t.covariance = means[i], covs[i]


def embedding_distance(tracks, detections) -> np.ndarray:
    """Cosine distance between track smooth features and detection features."""
    cost = np.ones((len(tracks), len(detections)), np.float32)
    if cost.size == 0:
        return cost
    det_feats = np.asarray([d.curr_feat for d in detections], np.float32)
    trk_feats = np.asarray([t.smooth_feat for t in tracks], np.float32)
    cost = 1.0 - trk_feats @ det_feats.T
    return np.maximum(0.0, cost)


class BOTSORT(BYTETracker):
    def __init__(self, args=None, frame_rate: int = 30, proximity_thresh: float = 0.5,
                 appearance_thresh: float = 0.25, with_reid: bool = False,
                 gmc_method: str = "sparseOptFlow", **kw):
        super().__init__(args, frame_rate, **kw)
        if args is not None:
            proximity_thresh = getattr(args, "proximity_thresh", proximity_thresh)
            appearance_thresh = getattr(args, "appearance_thresh", appearance_thresh)
            with_reid = getattr(args, "with_reid", with_reid)
            gmc_method = getattr(args, "gmc_method", gmc_method)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        from edgeyolo_tpu_torch.trackers.gmc import GMC

        self.gmc = GMC(method=gmc_method)

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def multi_predict(self, tracks):
        """Predict with BOTrack's XYWH shared filter — BOTrack states are
        [cx,cy,w,h,...], so the base class's XYAH filter must not touch them
        (reference bot_sort.py BOTSORT.multi_predict)."""
        BOTrack.multi_predict(tracks)

    def init_track(self, dets, scores, cls, feats=None):
        if feats is not None:
            return [BOTrack(d, s, c, f) for d, s, c, f in zip(dets, scores, cls, feats)]
        return [BOTrack(d, s, c) for d, s, c in zip(dets, scores, cls)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if self.fuse_score:
            dists = fuse_score(dists, detections)
        if self.with_reid and tracks and detections and getattr(detections[0], "curr_feat", None) is not None:
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists
