"""Detection and classification heads, NCHW (edgeyolo_tpu/nn/modules/head.py).

Detect is the anchor-free head: per level a reg tower (cv2) of DFL logits
and a cls tower (cv3), the legacy 3x3 pair or the DWConv + 1x1 pairs. The
decode concatenates the levels and runs in f32 whatever the tower dtype:
box coordinates span [0, imgsz] and bf16 would round them to about 2 px.
Output (B, A, 4 + nc): xywh boxes in input pixels, class probabilities.

GFLHeadv2_uniH is GF2Detect: Detect plus the DGQP quality mini-head
(reg_conf) over the top-k statistics of each side's DFL distribution,
whose quality multiplies the class probabilities.

v10Detect is Detect made end to end: the one2one towers and the top-k
below, with no quality.

Segment is Detect plus the mask prototypes (Proto on the first level, NCHW
(B, nm, 4H, 4W) at a quarter of the input size) and per-level towers (cv4)
of nm mask coefficients per anchor, (B, A, nm); in eval its pred carries
the coefficients after the classes, (B, A, 4 + nc + nm), so NMS keeps them
with their boxes.

OBB is Detect plus per-level towers (cv4) of one angle per anchor,
(sigmoid - 0.25) * pi, with the boxes decoded by the rotated dist2rbox;
Pose is Detect plus per-level towers (cv4) of K x D keypoint values per
anchor, decoded to input pixels (and a visibility probability). Their
towers are Segment's cv4 form.

End-to-end (NMS-free) heads, E2EDetect and its alias GFLHeadv2_E2E:
GF2Detect with a second set of towers and quality heads (`one2one_*`) fed
with detached inputs, as JAX's stop_gradient. They decode their one2one
branch straight to xyxy and keep the `max_det` best (anchor, class) pairs
by `e2e_postprocess`: pred is (B, max_det, 6) [x1, y1, x2, y2, score, cls].
In eval mode the one2many towers, which only the training loss reads, are
not run (under jit XLA drops them from JAX's inference too).

RTDETRDecoder is RT-DETR's query head: per level a 1x1 conv and BatchNorm
to the hidden width, the levels' tokens concatenated; anchors over the
flattened grid (cell centres, a side of 0.05 x 2^level, as logits; those
within 0.01 of the border at logit 1e6); the encoder's output projection,
LayerNorm and score head over the tokens (the invalid anchors' tokens at
0); the top min(300, A) tokens by their best class logit, in
jax.lax.top_k's order (`topk_stable`), as the decoder's queries (detached
in training) with the encoder's box head added to their anchors as the
reference logits; in training the contrastive-denoising queries (`dn`)
before them, with the attention mask that keeps each dn group to itself
and the real queries from every dn query; six deformable decoder layers.
In eval pred is (B, nq, 4 + nc): normalised cxcywh boxes and sigmoid
scores, in f32; in training the dict carries every layer's boxes and
logits, the encoder's proposals, and the dn queries' outputs apart.

Classify is the classification head: a ConvBN to 1280 channels (of the
inputs concatenated on channels when it is given several), the global mean,
dropout in training only, and a Linear to nc: logits, (B, nc).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import DFL, Proto
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, DWConv, batch_norm, norm_f32
from edgeyolo_tpu_torch.nn.modules.transformer import (MLP, DeformableTransformerDecoder,
                                                       inverse_sigmoid, layer_norm)
from edgeyolo_tpu_torch.ops.boxes import dist2bbox, dist2rbox, make_anchors
from edgeyolo_tpu_torch.utils import uniform_


def topk_small(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """Top-k values over a small axis by k masked max sweeps, largest first.

    +iota*1e-7 makes the values distinct, so each sweep removes exactly one
    element and duplicates keep their multiplicity (GF2Detect._topk_small);
    a plain torch.topk breaks ties differently.
    """
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    cur = x + (torch.arange(n, dtype=x.dtype, device=x.device) * 1e-7).view(shape)
    vals = []
    for _ in range(k):
        m = cur.amax(dim=dim, keepdim=True)
        vals.append(m)
        cur = torch.where(cur == m, -torch.inf, cur)
    return torch.cat(vals, dim=dim)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, largest
    first and, among equal values, the lower index first: jax.lax.top_k's
    order. torch.topk promises no order among ties (and the CUDA one differs
    from the CPU one); a stable descending sort keeps equal values in index
    order."""
    vals, idx = x.sort(dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def e2e_postprocess(preds: torch.Tensor, max_det: int, nc: int) -> torch.Tensor:
    """NMS-free selection of an end-to-end head (JAX head.py e2e_postprocess):
    the max_det anchors of highest best-class score, then the max_det best
    (anchor, class) pairs among them. preds (B, A, 4 + nc) with xyxy boxes ->
    (B, max_det, 6) [x1, y1, x2, y2, score, cls], score-sorted."""
    boxes, scores = preds[..., :4], preds[..., 4:4 + nc]
    k = min(max_det, scores.shape[1])
    _, ix = topk_stable(scores.amax(dim=-1), k)
    boxes = boxes.gather(1, ix[..., None].expand(-1, -1, 4))
    scores = scores.gather(1, ix[..., None].expand(-1, -1, nc))
    top, fi = topk_stable(scores.flatten(1), k)
    bsel = boxes.gather(1, (fi // nc)[..., None].expand(-1, -1, 4))
    return torch.cat([bsel, top[..., None], (fi % nc)[..., None].to(preds.dtype)], dim=-1)


def _tower_lists(ch: Sequence[int], nc: int, reg_max: int, legacy: bool,
                 cls_out: int | None = None):
    """The per-level reg (cv2) and cls (cv3) towers; the cls towers end in
    `cls_out` channels (a World head's text embedding) or nc."""
    c2 = max(16, ch[0] // 4, reg_max * 4)
    c3 = max(ch[0], min(nc, 100))
    cv2 = nn.ModuleList(
        nn.Sequential(ConvBN(x, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
        for x in ch)
    if legacy:
        cv3 = nn.ModuleList(
            nn.Sequential(ConvBN(x, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, cls_out or nc, 1))
            for x in ch)
    else:
        cv3 = nn.ModuleList(
            nn.Sequential(nn.Sequential(DWConv(x, x, 3), ConvBN(x, c3, 1)),
                          nn.Sequential(DWConv(c3, c3, 3), ConvBN(c3, c3, 1)),
                          nn.Conv2d(c3, nc, 1))
            for x in ch)
    return cv2, cv3


class Detect(nn.Module):
    """Anchor-free decoupled detection head over the pyramid levels; with
    `end2end` (the class default of the E2E heads) also the one2one towers."""

    end2end = False

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, legacy: bool = False, max_det: int = 300):
        super().__init__()
        self.nc, self.reg_max, self.stride, self.max_det = nc, reg_max, tuple(stride), max_det
        self.cv2, self.cv3 = _tower_lists(ch, nc, reg_max, legacy)
        if self.end2end:
            self.one2one_cv2, self.one2one_cv3 = _tower_lists(ch, nc, reg_max, legacy)
        self.dfl = DFL(reg_max)

    @torch.no_grad()
    def bias_init(self):
        """Box logits start at 1, class logits at the 5-objects-per-640px-image
        prior, in both branches."""
        pairs = [(self.cv2, self.cv3)]
        if self.end2end:
            pairs.append((self.one2one_cv2, self.one2one_cv3))
        for cv2, cv3 in pairs:
            for seq in cv2:
                seq[-1].bias.fill_(1.0)
            for seq, s in zip(cv3, self.stride):
                seq[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def decode(self, feats, quality=None):
        """Levels -> (B, A, 4 + nc) in f32: DFL integral boxes (xywh, or xyxy
        when end2end), sigmoid cls (times the clipped quality when there is
        one); end2end then selects (B, max_det, 6) by `e2e_postprocess`. The
        class count is the feats' (a World head's is its texts')."""
        b = feats[0].shape[0]
        flat = torch.cat([f.flatten(2) for f in feats], dim=2).float().transpose(1, 2)
        nc = flat.shape[-1] - 4 * self.reg_max
        box_logits, cls_logits = flat.split((4 * self.reg_max, nc), dim=-1)
        anchors, strides = make_anchors([f.shape[-2:] for f in feats], self.stride,
                                        device=flat.device)
        dbox = dist2bbox(self.dfl(box_logits), anchors[None], xywh=not self.end2end) * strides[None]
        cls_prob = torch.sigmoid(cls_logits)
        if quality is not None:
            q = torch.cat([qi.reshape(b, -1, 1) for qi in quality], dim=1)
            cls_prob = cls_prob * q.clamp(1e-6, 1 - 1e-6)
        out = torch.cat([dbox, cls_prob], dim=-1)
        return e2e_postprocess(out, self.max_det, nc) if self.end2end else out

    def towers(self, xs, one2one: bool = False):
        """(box logits per level, feats per level) of the one2many branch, or
        of the one2one branch on detached inputs."""
        cv2, cv3 = self.cv2, self.cv3
        if one2one:
            cv2, cv3 = self.one2one_cv2, self.one2one_cv3
            xs = [x.detach() for x in xs]
        boxes = [m(x) for m, x in zip(cv2, xs)]
        return boxes, [torch.cat([bx, m(x)], dim=1) for bx, m, x in zip(boxes, cv3, xs)]

    def one2many(self, xs) -> None:
        """Run the one2many branch alone, for its side effects: an
        end-to-end head's eval forward skips it, JAX's computes it, and int8
        calibration (nn/quant.py) observes its convs as JAX's does."""
        self.towers(xs)

    def forward(self, xs):
        out = {}
        if self.training or not self.end2end:
            out["feats"] = self.towers(xs)[1]
        if self.end2end:
            out["one2one_feats"] = self.towers(xs, one2one=True)[1]
        if not self.training:
            out["pred"] = self.decode(out["one2one_feats" if self.end2end else "feats"])
        return out


class v10Detect(Detect):
    """YOLOv10's NMS-free head: Detect with the one2one towers and the top-k
    selection, without quality (its cls towers are the DWConv pairs)."""

    end2end = True


class GFLHeadv2_uniH(Detect):
    """Detect + DGQP quality head (the working semantics of GF2Detect)."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, legacy: bool = False, max_det: int = 300, reg_topk: int = 4,
                 add_mean: bool = True, reg_channels: int = 64):
        super().__init__(nc, ch, stride, reg_max, legacy, max_det)
        self.reg_topk, self.add_mean = reg_topk, add_mean
        stat_ch = 4 * (min(reg_topk, reg_max) + int(add_mean))

        def heads():
            return nn.ModuleList(
                nn.Sequential(nn.Conv2d(stat_ch, reg_channels, 1), nn.ReLU(),
                              nn.Conv2d(reg_channels, 1, 1), nn.Sigmoid())
                for _ in ch)

        self.reg_conf = heads()
        if self.end2end:
            self.one2one_reg_conf = heads()

    def quality_heads(self) -> list[nn.Module]:
        """The quality mini-heads (one set per branch): the f32 island."""
        return [self.reg_conf] + ([self.one2one_reg_conf] if self.end2end else [])

    def quality(self, box_logits: torch.Tensor, i: int, one2one: bool = False) -> torch.Tensor:
        """DGQP: top-k and mean of each side's DFL distribution -> (B, 1, H, W) in [0, 1].

        Runs in f32 (the 1e-7 tie-break is below bf16 resolution), autocast or not."""
        b, _, h, w = box_logits.shape
        with torch.autocast(box_logits.device.type, enabled=False):
            prob = box_logits.float().view(b, 4, self.reg_max, h, w).softmax(dim=2)
            parts = [topk_small(prob, min(self.reg_topk, self.reg_max), dim=2)]
            if self.add_mean:
                parts.append(prob.mean(dim=2, keepdim=True))
            stat = torch.cat(parts, dim=2).flatten(1, 2)  # side-major, (B, 4*(k+1), H, W)
            return (self.one2one_reg_conf if one2one else self.reg_conf)[i](stat)

    def one2many(self, xs) -> None:
        boxes, _ = self.towers(xs)
        for i, bx in enumerate(boxes):
            self.quality(bx, i)

    def forward(self, xs):
        out = {}
        if self.training or not self.end2end:
            boxes, out["feats"] = self.towers(xs)
            out["quality"] = [self.quality(bx, i) for i, bx in enumerate(boxes)]
        if self.end2end:
            boxes, out["one2one_feats"] = self.towers(xs, one2one=True)
            out["one2one_quality"] = [self.quality(bx, i, one2one=True)
                                      for i, bx in enumerate(boxes)]
        if not self.training:
            key = "one2one_" if self.end2end else ""
            out["pred"] = self.decode(out[key + "feats"], out[key + "quality"])
        return out


class E2EDetect(GFLHeadv2_uniH):
    """End-to-end (NMS-free) GF2Detect: the one2one branch and the top-k selection."""

    end2end = True


GFLHeadv2_E2E = E2EDetect  # the thesis's name for the GFLv2 head in its NMS-free form


def _cv4(ch: Sequence[int], c4: int, n_out: int) -> nn.ModuleList:
    """Per-level towers of n_out extra channels per anchor (mask coefficients,
    angles, keypoints): two 3x3 ConvBN and a 1x1 conv."""
    return nn.ModuleList(
        nn.Sequential(ConvBN(x, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, n_out, 1)) for x in ch)


def _per_anchor(towers: nn.ModuleList, xs) -> torch.Tensor:
    """The towers' outputs over the levels as (B, A, C), anchors row-major per level."""
    return torch.cat([m(x).flatten(2) for m, x in zip(towers, xs)], dim=2).transpose(1, 2)


class Segment(Detect):
    """Detect + the Proto bank and the per-anchor mask coefficients."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: Sequence[int] = (),
                 stride: Sequence[int] = (8, 16, 32), reg_max: int = 16, legacy: bool = False,
                 max_det: int = 300):
        super().__init__(nc, ch, stride, reg_max, legacy, max_det)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = _cv4(ch, max(ch[0] // 4, nm), nm)

    def forward(self, xs):
        out = {"feats": self.towers(xs)[1], "proto": self.proto(xs[0]),
               "mask_coefs": _per_anchor(self.cv4, xs)}
        if not self.training:
            out["pred"] = torch.cat([self.decode(out["feats"]), out["mask_coefs"].float()], dim=-1)
        return out


class OBB(Detect):
    """Detect + a per-anchor angle in [-pi/4, 3pi/4): (sigmoid(t) - 0.25) * pi.
    Boxes decode by the rotated dist2rbox, in f32 whatever the tower dtype
    (the angle too); in eval pred is (B, A, 4 + nc + 1), xywh of the
    rotated extent, class probabilities, angle. The training dict carries
    `angle` (B, A, 1)."""

    def __init__(self, nc: int = 80, ne: int = 1, ch: Sequence[int] = (),
                 stride: Sequence[int] = (8, 16, 32), reg_max: int = 16, legacy: bool = False,
                 max_det: int = 300):
        super().__init__(nc, ch, stride, reg_max, legacy, max_det)
        self.ne = ne
        self.cv4 = _cv4(ch, max(ch[0] // 4, ne), ne)

    def decode_rotated(self, feats, angle: torch.Tensor) -> torch.Tensor:
        flat = torch.cat([f.flatten(2) for f in feats], dim=2).float().transpose(1, 2)
        box_logits, cls_logits = flat.split((4 * self.reg_max, self.nc), dim=-1)
        anchors, strides = make_anchors([f.shape[-2:] for f in feats], self.stride,
                                        device=flat.device)
        rbox = dist2rbox(self.dfl(box_logits), angle, anchors[None]) * strides[None]
        return torch.cat([rbox, torch.sigmoid(cls_logits)], dim=-1)

    def forward(self, xs):
        angle = (torch.sigmoid(_per_anchor(self.cv4, xs).float()) - 0.25) * math.pi
        out = {"feats": self.towers(xs)[1], "angle": angle}
        if not self.training:
            out["pred"] = torch.cat([self.decode_rotated(out["feats"], angle), angle], dim=-1)
        return out


class Pose(Detect):
    """Detect + K x D keypoint regressions per anchor (kpt_shape (K, D)):
    xy decoded as (raw * 2 + anchor - 0.5) * stride, the visibility (D = 3)
    by a sigmoid, in f32; in eval pred is (B, A, 4 + nc + K * D). The
    training dict carries the raw `kpts_raw` (B, A, K * D)."""

    def __init__(self, nc: int = 80, kpt_shape: Sequence[int] = (17, 3), ch: Sequence[int] = (),
                 stride: Sequence[int] = (8, 16, 32), reg_max: int = 16, legacy: bool = False,
                 max_det: int = 300):
        super().__init__(nc, ch, stride, reg_max, legacy, max_det)
        self.kpt_shape = tuple(int(k) for k in kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _cv4(ch, max(ch[0] // 4, self.nk), self.nk)

    def kpts_decode(self, kpts: torch.Tensor, shapes) -> torch.Tensor:
        b, a, _ = kpts.shape
        k, d = self.kpt_shape
        anchors, strides = make_anchors(shapes, self.stride, device=kpts.device)
        y = kpts.float().view(b, a, k, d)
        xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * strides[None, :, None, :]
        if d == 3:
            xy = torch.cat([xy, torch.sigmoid(y[..., 2:3])], dim=-1)
        return xy.reshape(b, a, self.nk)

    def forward(self, xs):
        out = {"feats": self.towers(xs)[1], "kpts_raw": _per_anchor(self.cv4, xs)}
        if not self.training:
            shapes = [f.shape[-2:] for f in out["feats"]]
            out["pred"] = torch.cat([self.decode(out["feats"]),
                                     self.kpts_decode(out["kpts_raw"], shapes)], dim=-1)
        return out


class Classify(nn.Module):
    """conv (ConvBN to 1280) -> global mean -> dropout (training only) ->
    linear: class logits (B, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, dropout: float = 0.0):
        super().__init__()
        c_ = 1280
        self.conv = ConvBN(c1, c_, k, s, p, g)
        self.drop = nn.Dropout(dropout)
        self.linear = nn.Linear(c_, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        return self.linear(self.drop(self.conv(x).mean((2, 3))))


def cdn_attention_mask(d: int, nq: int, group_size: int, device=None) -> torch.Tensor:
    """(d + nq, d + nq) bool, True = blocked: the real queries never see the
    d denoising queries (groups of group_size), and each dn group sees no
    other dn group."""
    i = torch.arange(d + nq, device=device)
    group = torch.where(i < d, i // group_size, -1)
    return (i[None] < d) & ((i[:, None] >= d) | (group[:, None] != group[None]))


class RTDETRDecoder(nn.Module):
    """RT-DETR query decoder head over the pyramid levels."""

    FOCAL_PRIOR = -math.log((1 - 0.01) / 0.01)  # bias_init_with_prob(0.01), whatever nc

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32),
                 hd: int = 256, nq: int = 300, ndp: int = 4, nh: int = 8, ndl: int = 6,
                 d_ffn: int = 1024, learnt_init_query: bool = False):
        super().__init__()
        self.nc, self.hd, self.nq, self.stride = nc, hd, nq, tuple(stride)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False), batch_norm(hd)) for c in ch)
        self.decoder = DeformableTransformerDecoder(hd, ndl, nh, d_ffn, len(ch), ndp)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        self.learnt_init_query = learnt_init_query
        if learnt_init_query:
            self.tgt_embed = nn.Embedding(nq, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=1e-5))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """The denoising class embedding ~ N(0, 1), the learnt queries xavier-uniform."""
        w = self.denoising_class_embed.weight
        w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32))
        if self.learnt_init_query:
            uniform_(self.tgt_embed.weight, (6.0 / sum(self.tgt_embed.weight.shape)) ** 0.5,
                     generator)

    @torch.no_grad()
    def bias_init(self):
        """Every score head's bias at the 0.01 focal prior."""
        for m in (self.enc_score_head, *self.dec_score_head):
            m.bias.fill_(self.FOCAL_PRIOR)

    @staticmethod
    def anchors(shapes, device=None, grid_size: float = 0.05, eps: float = 1e-2):
        """(1, A, 4) anchor logits in f32 and (1, A, 1) their validity."""
        out = []
        for i, (h, w) in enumerate(shapes):
            sy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            sx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            xy = torch.stack([gx, gy], -1).reshape(-1, 2)
            out.append(torch.cat([xy, torch.full_like(xy, grid_size * 2.0 ** i)], -1))
        a = torch.cat(out)[None]
        valid = ((a > eps) & (a < 1 - eps)).all(dim=-1, keepdim=True)
        # large-finite, not inf: sigmoid(1e6) is 1 in f32 and the gradient stays finite
        return torch.where(valid, torch.log(a / (1 - a)), 1e6), valid

    def forward(self, xs, dn: dict | None = None):
        b = xs[0].shape[0]
        feats, shapes = [], []
        for proj, x in zip(self.input_proj, xs):
            p = norm_f32(proj[1], proj[0](x))
            shapes.append(tuple(p.shape[2:]))
            feats.append(p.flatten(2).transpose(1, 2))
        feats = torch.cat(feats, dim=1)  # (B, A, hd)
        anchors, valid = self.anchors(shapes, feats.device)
        features = layer_norm(self.enc_output[1],
                              self.enc_output[0](torch.where(valid, feats, 0.0)))
        enc_scores_all = self.enc_score_head(features)
        nq = min(self.nq, feats.shape[1])
        _, ix = topk_stable(enc_scores_all.float().amax(dim=-1), nq)
        top_feats = features.gather(1, ix[..., None].expand(-1, -1, self.hd))
        refer = (self.enc_bbox_head(top_feats).float()
                 + anchors.expand(b, -1, -1).gather(1, ix[..., None].expand(-1, -1, 4)))
        out = {"enc_bboxes": refer.sigmoid(),
               "enc_scores": enc_scores_all.gather(1, ix[..., None].expand(-1, -1, self.nc))}
        if self.learnt_init_query:
            embed = self.tgt_embed.weight[None].expand(b, -1, -1).to(features.dtype)
        else:
            embed = top_feats.detach() if self.training else top_feats
        if self.training:
            refer = refer.detach()
        mask, d = None, 0
        if dn is not None:
            dn_embed = self.denoising_class_embed.weight[dn["cls"]].to(embed.dtype)
            d = dn_embed.shape[1]
            mask = cdn_attention_mask(d, embed.shape[1], int(dn["group_size"]), feats.device)
            embed = torch.cat([dn_embed, embed], dim=1)
            refer = torch.cat([inverse_sigmoid(dn["bbox"].float()), refer], dim=1)
        box, score, boxes, scores = self.decoder(embed, refer, feats, shapes, self.dec_bbox_head,
                                                 self.dec_score_head, self.query_pos_head, mask)
        if d:
            out["dn_feats"] = [box[:, :d], score[:, :d]]
            out["dn_aux"] = ([t[:, :d] for t in boxes], [t[:, :d] for t in scores])
            box, score = box[:, d:], score[:, d:]
            boxes, scores = [t[:, d:] for t in boxes], [t[:, d:] for t in scores]
        out["feats"] = [box, score]
        out["aux"] = (boxes, scores)
        if not self.training:
            out["pred"] = torch.cat([box, score.float().sigmoid()], dim=-1)
        return out
