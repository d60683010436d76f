"""The SAM2 facades (edgeyolo_tpu/engine/sam2.py): promptable image
segmentation, and video tracking through a memory bank.

    sam = SAM2("sam2_t")                 # or sam2_s, sam2_b, sam2_l; seeded weights
    sam.set_image(img)                   # HWC uint8 (or gray HW)
    masks, ious = sam(points=[[100, 200]], labels=[1])
    anns = sam.generate(img)             # segment everything (engine/sam.py::grid_generate)

    vp = SAM2VideoPredictor("sam2_t")
    vp.init_state(frames)                # a list of HWC frames
    mask0, score0 = vp.add_points(0, points=[[x, y]], labels=[1])
    for fidx, mask, score in vp.propagate():
        ...

`set_image` resizes and normalises as the SAM facade does
(engine/sam.py::preprocess). A call prompts the cached features
plus the no-memory embedding with points (shifted by +0.5 to the pixel
centre, then divided by the image size, as JAX's facade does) and boxes
(corner points, labels 2 and 3, not shifted) through `sam_heads` with
multimask output; `multimask_output` returns the best of the three by
predicted IoU, otherwise the heads' chosen mask with the first IoU, as
JAX's facade does. Everything computes in f32 on the model's device (CUDA
unless `device` names another).

The video predictor keeps JAX's bank logic: conditioning frames at temporal
slot 0, the previous `num_maskmem - 1` frames at slots 1...; each memory's
positions plus `maskmem_tpos_enc[num_maskmem - t_pos - 1]`; the object
pointers of the conditioning frames and of up to `max_obj_ptrs - 1`
previous frames, each (1, 256) split into four 64-channel tokens with its
temporal sine encoding repeated four times. The bank (memories, positions,
pointers, low-resolution logits) stays as tensors on the model's device;
the encoded-frame cache holds at most 8 frames.
"""

from __future__ import annotations

import numpy as np
import torch

from edgeyolo_tpu_torch.engine.sam import grid_generate, preprocess
from edgeyolo_tpu_torch.nn.sam2 import build_sam2
from edgeyolo_tpu_torch.ops.resize import resize_bilinear
from edgeyolo_tpu_torch.utils import LOGGER, select_device

ENC_CACHE = 8


class SAM2:
    """Promptable image segmentation with a SAM2 (Hiera) backbone."""

    def __init__(self, model: str = "sam2_t", img_size: int = 1024, seed: int = 0,
                 device: str | torch.device | None = None):
        if str(model).endswith((".pt", ".pth")):
            raise NotImplementedError("SAM2 .pt weight conversion is not supported; pass a "
                                      "variant name")
        self.device = select_device(device)
        self.img_size = int(img_size)
        self.net = build_sam2(str(model), img_size=self.img_size, seed=seed).to(self.device)
        self._enc = None
        self._hw = None
        LOGGER.info(f"SAM2 {model} ready (img_size={self.img_size})")

    @torch.inference_mode()
    def encode(self, img: np.ndarray) -> dict:
        return self.net.encode_image(preprocess(img, self.img_size, self.device))

    def set_image(self, img: np.ndarray) -> "SAM2":
        """Encode one image and cache its features."""
        self._hw = img.shape[:2]
        self._enc = self.encode(img)
        return self

    def points01(self, points, w: int, h: int) -> np.ndarray:
        """Pixel points of a (w, h) image -> [0, 1] at their pixel centres."""
        p = np.atleast_2d(np.asarray(points, np.float32))
        return ((p * [self.img_size / w, self.img_size / h] + 0.5) / self.img_size).astype(
            np.float32)

    @torch.inference_mode()
    def __call__(self, points=None, labels=None, bboxes=None, multimask_output: bool = False):
        """Prompt the cached features: points (N, 2) in the original image's
        pixels with labels (N,), and/or bboxes (4,) or (K, 4) xyxy. Returns
        (masks (1, H, W) bool at the original size, iou (1,))."""
        if self._enc is None:
            raise RuntimeError("call set_image() first")
        h, w = self._hw
        pts, labs = [], []
        if points is not None:
            p = self.points01(points, w, h)
            pts.append(p)
            labs.append(np.asarray(labels if labels is not None else np.ones(len(p)), np.int32))
        if bboxes is not None:
            for x1, y1, x2, y2 in np.atleast_2d(np.asarray(bboxes, np.float32)):
                pts.append(np.asarray([[x1 / w, y1 / h], [x2 / w, y2 / h]], np.float32))
                labs.append(np.asarray([2, 3], np.int32))
        if not pts:
            raise ValueError("provide points and/or bboxes")
        p = torch.from_numpy(np.concatenate(pts, 0).astype(np.float32))[None].to(self.device)
        lab = torch.from_numpy(np.concatenate(labs, 0).astype(np.int32))[None].to(self.device)
        enc = self._enc
        low_multi, ious, low_res, *_ = self.net.sam_heads(
            self.net.no_memory_features(enc["feat"]), p, lab, enc["feat_s0"], enc["feat_s1"],
            multimask_output=True)
        best = int(ious[0].argmax()) if multimask_output else 0
        m = low_multi[:, best:best + 1] if multimask_output else low_res
        m = resize_bilinear(m, (h, w))[0]
        return (m > 0.0).cpu().numpy(), ious[0, best:best + 1].cpu().numpy()

    @torch.inference_mode()
    def _prompt_batch(self, pts01: np.ndarray):
        """Single-point prompts (B, 2) xy in [0, 1] against the cached
        features: (multimask logits (B, 3, h, w), iou (B, 3)), on the device."""
        if self._enc is None:
            raise RuntimeError("call set_image() first")
        b, enc = len(pts01), self._enc
        feat = self.net.no_memory_features(enc["feat"]).expand(b, -1, -1, -1)
        p = torch.as_tensor(np.asarray(pts01, np.float32), device=self.device)[:, None]
        lab = torch.ones(b, 1, dtype=torch.int32, device=self.device)
        out = self.net.sam_heads(feat, p, lab, enc["feat_s0"].expand(b, -1, -1, -1),
                                 enc["feat_s1"].expand(b, -1, -1, -1), multimask_output=True)
        return out[0], out[1]

    def generate(self, img, **kw):
        """Segment everything (`grid_generate`)."""
        return grid_generate(self, img, **kw)

    def info(self) -> int:
        n = sum(p.numel() for p in self.net.parameters())
        LOGGER.info(f"SAM2: {n:,} params, encoder img_size {self.img_size}")
        return n


class SAM2VideoPredictor:
    """Promptable video object tracking with a per-frame memory bank."""

    def __init__(self, model: str = "sam2_t", img_size: int = 1024, seed: int = 0,
                 num_maskmem: int = 7, max_obj_ptrs: int = 16,
                 device: str | torch.device | None = None):
        self.sam = SAM2(model, img_size=img_size, seed=seed, device=device)
        self.net, self.device = self.sam.net, self.sam.device
        self.num_maskmem = num_maskmem
        self.max_obj_ptrs = max_obj_ptrs
        self.reset()

    def reset(self):
        self.frames = None
        self.cond: dict[int, dict] = {}
        self.non_cond: dict[int, dict] = {}
        self._enc_cache: dict[int, dict] = {}

    def init_state(self, frames):
        self.reset()
        self.frames = list(frames)
        return self

    # -- internals ---------------------------------------------------------------
    def _enc(self, fidx: int) -> dict:
        if fidx not in self._enc_cache:
            self._enc_cache[fidx] = self.sam.encode(self.frames[fidx])
            if len(self._enc_cache) > ENC_CACHE:
                self._enc_cache.pop(min(k for k in self._enc_cache if k != fidx))
        return self._enc_cache[fidx]

    def _assemble_memory(self, fidx: int):
        """The memories and object pointers frame `fidx` attends to: (memory
        (1, M, 64), positions (1, M, 64), pointer tokens at the end)."""
        items = [(0, self.cond[t]) for t in sorted(self.cond)]
        for t_pos in range(1, self.num_maskmem):
            prev = fidx - (self.num_maskmem - t_pos)
            out = self.non_cond.get(prev) or self.cond.get(prev)
            if out is not None:
                items.append((t_pos, out))
        tpos_enc = self.net.maskmem_tpos_enc
        mems = [out["maskmem"].flatten(2).transpose(1, 2) for _, out in items]
        poss = [out["maskmem_pos"].flatten(2).transpose(1, 2)
                + tpos_enc[self.num_maskmem - t_pos - 1, 0] for t_pos, out in items]
        ptrs, tdiffs = [], []
        for t in sorted(self.cond):
            if t <= fidx:
                ptrs.append(self.cond[t]["obj_ptr"])
                tdiffs.append(fidx - t)
        for td in range(1, self.max_obj_ptrs):
            t = fidx - td
            if t < 0:
                break
            out = self.non_cond.get(t)
            if out is not None and t not in self.cond:
                ptrs.append(out["obj_ptr"])
                tdiffs.append(td)
        n_ptr_tokens = 0
        if ptrs:
            n = len(ptrs)
            mems.append(torch.stack(ptrs, 1).reshape(1, n * 4, 64))
            tdiff = torch.tensor(tdiffs, dtype=torch.float32, device=self.device)
            tp = self.net.tpos_ptr(tdiff / (self.max_obj_ptrs - 1))
            poss.append(tp.repeat_interleave(4, dim=0)[None])
            n_ptr_tokens = n * 4
        return torch.cat(mems, 1), torch.cat(poss, 1), n_ptr_tokens

    @torch.inference_mode()
    def _step(self, fidx: int, points=None, labels=None, is_cond: bool = False) -> dict:
        enc = self._enc(fidx)
        if is_cond or not (self.cond or self.non_cond):
            feat = self.net.no_memory_features(enc["feat"])
        else:
            memory, mpos, nptr = self._assemble_memory(fidx)
            feat = self.net.condition_features(enc["feat"], enc["pos"], memory, mpos, nptr)
        h, w = self.frames[fidx].shape[:2]
        if points is not None:
            p = self.sam.points01(points, w, h)
            lab = np.asarray(labels if labels is not None else np.ones(len(p)), np.int32)
        else:
            p, lab = np.zeros((1, 2), np.float32), -np.ones((1,), np.int32)
        low_multi, ious, low_res, hi, obj_ptr, obj_logits = self.net.sam_heads(
            feat, torch.as_tensor(p[None], device=self.device),
            torch.as_tensor(lab[None], device=self.device), enc["feat_s0"], enc["feat_s1"],
            multimask_output=points is not None)
        best = int(ious[0].argmax()) if points is not None else 0
        low = low_multi[:, best:best + 1] if points is not None else low_res
        mem, mem_pos = self.net.encode_memory(enc["feat"], hi, obj_logits)
        rec = {"maskmem": mem, "maskmem_pos": mem_pos, "obj_ptr": obj_ptr, "low_res": low,
               "score": float(ious[0, best]), "obj_logits": float(obj_logits[0])}
        (self.cond if is_cond else self.non_cond)[fidx] = rec
        return rec

    # -- public API ---------------------------------------------------------------
    def add_points(self, frame_idx: int, points, labels=None):
        """Register a conditioning frame with point prompts: (mask, score)."""
        rec = self._step(frame_idx, points=points, labels=labels, is_cond=True)
        return self._mask_at(frame_idx, rec), rec["score"]

    @torch.inference_mode()
    def _mask_at(self, fidx: int, rec) -> np.ndarray:
        h, w = self.frames[fidx].shape[:2]
        return (resize_bilinear(rec["low_res"], (h, w))[0, 0] > 0.0).cpu().numpy()

    def propagate(self, start: int | None = None):
        """Track the prompted object through the video; yields (frame_idx,
        mask (H, W) bool, score)."""
        if not self.cond:
            raise RuntimeError("add_points() on at least one frame first")
        start = min(self.cond) if start is None else start
        for fidx in range(start, len(self.frames)):
            rec = self.cond[fidx] if fidx in self.cond else self._step(fidx)
            yield fidx, self._mask_at(fidx, rec), rec["score"]
