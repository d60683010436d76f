"""SAM2 (edgeyolo_tpu/nn/sam2.py): a Hiera image encoder with an FPN neck,
the SAM2 mask decoder, and the memory path of video tracking.

- Positions: `sine_pos_embed_2d` (normalised sine, channels [y, x], in f64
  then f32), `get_1d_sine_pe` (the object pointers' temporal encoding) and
  the axial RoPE tables, applied to adjacent channel pairs.
- Hiera: a 7 x 7 stride-4 patch embedding, a background position resized
  by jax.image.resize's cubic rule (Keys, a = -0.5, weights renormalised at
  the border: ops/resize.py) plus a tiled window position, then
  MultiScaleBlocks: windowed attention (windows padded with zeros), global
  blocks at window 0, and at each stage's first block a 2 x 2 max pool of
  the queries and of the projected shortcut, after which the window halves.
  Stage outputs are NCHW, high resolution first.
- FpnNeck: a 1 x 1 lateral conv a level, nearest 2x top-down only into
  levels (2, 3), sine positions; ImageEncoder drops the lowest level.
- SAM2MaskDecoder: the object-score, IoU and four mask tokens with the
  prompts through the port's two-way transformer (nn/sam.py), the stride-8
  and stride-4 features added after each transposed conv, a hypernetwork
  MLP a mask token, a sigmoid IoU head and an object-score head.
- MemoryEncoder: the mask (already sigmoid x 20 - 10) down 16x by four 3 x 3
  stride-2 convs, each followed by a channel LayerNorm (eps 1e-6) and GELU,
  a 1 x 1 conv, added to the projected pixel features, two ConvNeXt blocks,
  a 1 x 1 conv to 64 channels.
- MemoryAttention: four layers of RoPE self-attention, RoPE cross-attention
  to the 64-channel memory (the table tiled over memory frames; the trailing
  object-pointer tokens not rotated) and an FFN, after 0.1 x the positions
  are added to the input.
- SAM2Model: encode_image, sam_heads (the hard object gate at -1024,
  multimask by predicted IoU or the dynamic choice by stability, argmax ties
  to the first index, the high-resolution mask by jax.image.resize's
  bilinear rule), condition_features, no_memory_features, encode_memory,
  tpos_ptr, downsample_mask and the forward that touches every path;
  SAM2_CONFIGS (t, s, b, l) and build_sam2 with seeded weights.

Attention is plain matmuls and a softmax in f32, as JAX computes it outside
any kernel. Parameter names are the reference's state_dict keys
(`image_encoder.trunk.blocks.{i}`, `sam_mask_decoder.conv_s0`,
`memory_encoder.mask_downsampler.encoder.{j}`, `memory_attention.layers.
{i}`, ...), so the reference's own state_dict loads strictly. Modules take
and give NCHW maps; token sequences are (B, N, C) in row-major order.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.transformer import layer_norm
from edgeyolo_tpu_torch.nn.sam import (MLP, LayerNorm2d, PromptEncoder, TwoWayTransformer,
                                       init_sam, window_partition, window_unpartition)
from edgeyolo_tpu_torch.ops.resize import resize_bilinear, resize_cubic

NO_OBJ_SCORE = -1024.0


# --------------------------------------------------------------------------
# positional encodings
# --------------------------------------------------------------------------
@lru_cache(maxsize=32)
def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int = 128,
                      temperature: float = 10000.0) -> np.ndarray:
    """PositionEmbeddingSine, normalised: (h, w, 2 * num_pos_feats) f32 with
    channels [pos_y, pos_x], computed in f64 (read-only, cached)."""
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], -1).reshape(h, w, -1)
    out = np.concatenate([py, px], -1).astype(np.float32)
    out.flags.writeable = False
    return out


@lru_cache(maxsize=64)
def sine_pos_nchw(h: int, w: int, channels: int, device: torch.device) -> torch.Tensor:
    """`sine_pos_embed_2d` as a (1, channels, h, w) tensor on `device`, made
    once (level 0 of a 1024 px encode is 64 MiB) and never written to."""
    with torch.inference_mode(False):
        return torch.tensor(sine_pos_embed_2d(h, w, channels // 2), device=device).permute(
            2, 0, 1)[None]


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """1-D sinusoid of normalised positions (N,) -> (N, dim): [sin, cos]."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    pe = pos[..., None] / dim_t
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=-1)


@lru_cache(maxsize=16)
def axial_rope_table(dim: int, end_x: int, end_y: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """compute_axial_cis as (N, dim / 2) cos and sin tables (f64, then f32)
    on `device`, made once and never written to."""
    n_f = dim // 4
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 4)[:n_f].astype(np.float64) / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    ang = np.concatenate([np.outer(t % end_x, freqs), np.outer(np.floor(t / end_x), freqs)], -1)
    with torch.inference_mode(False):
        return (torch.tensor(np.cos(ang).astype(np.float32), device=device),
                torch.tensor(np.sin(ang).astype(np.float32), device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (x[..., 0::2], x[..., 1::2]) of x (..., N, D) by
    tables (N, D / 2)."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1).reshape(x.shape)


# --------------------------------------------------------------------------
# Hiera trunk
# --------------------------------------------------------------------------
def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 stride-2 max pool of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Attention over (B, H, W, C) tokens; with `q_pool`, the queries 2 x 2
    max-pooled (the output takes their size)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.num_heads, self.q_pool = num_heads, q_pool
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1).unbind(2)
        if self.q_pool:
            q = _max_pool2(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, -1)
        attn = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(q.shape[-1])
        o = torch.einsum("bhqk,bkhc->bqhc", attn.softmax(dim=-1), v)
        return self.proj(o.reshape(b, h, w, -1))


class MultiScaleBlock(nn.Module):
    """Pre-norm block; a width change projects the normed input for the
    shortcut (then pools it with `q_stride`)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride: bool = False,
                 window_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.q_stride, self.window_size = q_stride, window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool=q_stride)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP((dim_out, int(dim_out * mlp_ratio), dim_out), act=F.gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = layer_norm(self.norm1, x)
        if self.proj is not None:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = _max_pool2(shortcut)
        ws = self.window_size
        h, w = x.shape[1:3]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride:
            ws //= 2
            h, w = shortcut.shape[1:3]
            pad_hw = (h + (-h) % ws, w + (-w) % ws) if ws else (h, w)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(layer_norm(self.norm2, x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, 4, 3)


class Hiera(nn.Module):
    """(B, 3, S, S) -> the four stages' maps, NCHW, high resolution first."""

    def __init__(self, embed_dim: int = 96, num_heads: int = 1,
                 stages: Sequence[int] = (1, 2, 7, 2), global_att_blocks: Sequence[int] = (5, 7, 9),
                 window_pos_embed_bkg_spatial_size: Sequence[int] = (7, 7),
                 window_spec: Sequence[int] = (8, 4, 14, 7), q_pool: int = 3):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_dim, *window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, embed_dim, window_spec[0], window_spec[0]))
        self.stage_ends = [sum(stages[:i + 1]) - 1 for i in range(len(stages))]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:q_pool]
        blocks, dim, heads, cur_stage = [], embed_dim, num_heads, 1
        for i in range(sum(stages)):
            dim_out, window = dim, window_spec[cur_stage - 1]
            if i in global_att_blocks:
                window = 0
            if i - 1 in self.stage_ends:
                dim_out, heads = dim * 2, heads * 2
                cur_stage += 1
            blocks.append(MultiScaleBlock(dim, dim_out, heads, q_stride=i in q_pool_blocks,
                                          window_size=window))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def pos(self, h: int, w: int) -> torch.Tensor:
        """The background position resized to (h, w) plus the tiled window one."""
        win = self.pos_embed_window
        pos = resize_cubic(self.pos_embed, (h, w))
        return pos + win.tile(1, 1, h // win.shape[2], w // win.shape[3])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_embed.proj(x)
        x = (x + self.pos(*x.shape[2:])).permute(0, 2, 3, 1)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outputs.append(x.permute(0, 3, 1, 2))
        return outputs


class FpnNeck(nn.Module):
    """A 1 x 1 lateral a level (`convs[j]` takes channel_list[j], lowest
    resolution first), nearest 2x top-down into `fpn_top_down_levels`, the
    sum in f32; sine positions of each level."""

    def __init__(self, d_model: int = 256,
                 backbone_channel_list: Sequence[int] = (768, 384, 192, 96),
                 fpn_top_down_levels: Sequence[int] = (2, 3)):
        super().__init__()
        self.top_down = tuple(fpn_top_down_levels)
        self.convs = nn.ModuleList(nn.Sequential(OrderedDict(conv=nn.Conv2d(c, d_model, 1)))
                                   for c in backbone_channel_list)

    def forward(self, xs: list[torch.Tensor]):
        n = len(xs) - 1
        out, pos, prev = [None] * len(xs), [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i])
            if i in self.top_down and prev is not None:
                prev = lateral + F.interpolate(prev.float(), scale_factor=2.0, mode="nearest")
            else:
                prev = lateral
            out[i] = prev
            b, c, h, w = prev.shape
            pos[i] = sine_pos_nchw(h, w, c, prev.device).expand(b, -1, -1, -1)
        return out, pos


class ImageEncoder(nn.Module):
    """Trunk and neck; `scalp` drops that many of the lowest-resolution levels."""

    def __init__(self, trunk: Hiera, neck: FpnNeck, scalp: int = 1):
        super().__init__()
        self.trunk, self.neck, self.scalp = trunk, neck, scalp

    def forward(self, x: torch.Tensor) -> dict:
        feats, pos = self.neck(self.trunk(x))
        if self.scalp > 0:
            feats, pos = feats[:-self.scalp], pos[:-self.scalp]
        return {"vision_features": feats[-1], "vision_pos_enc": pos, "backbone_fpn": feats}


# --------------------------------------------------------------------------
# memory encoder
# --------------------------------------------------------------------------
class CXBlock(nn.Module):
    """ConvNeXt block: 7 x 7 depthwise conv, channel LayerNorm, pointwise MLP
    (x 4, GELU), scaled by `gamma`, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        y = self.gamma * self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + y.permute(0, 3, 1, 2)


class MaskDownSampler(nn.Module):
    def __init__(self, embed_dim: int = 256, layers: int = 4):
        super().__init__()
        mods, c = [], 1
        for _ in range(layers):
            mods += [nn.Conv2d(c, c * 4, 3, 2, 1), LayerNorm2d(c * 4, eps=1e-6), nn.GELU()]
            c *= 4
        self.encoder = nn.Sequential(*mods, nn.Conv2d(c, embed_dim, 1))

    def forward(self, x):
        return self.encoder(x)


class Fuser(nn.Module):
    def __init__(self, dim: int, layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    """pix_feat (B, in_dim, h, w) and masks (B, 1, 16h, 16w), already
    sigmoided and scaled -> (memory (B, out_dim, h, w), positions
    (1, out_dim, h, w))."""

    def __init__(self, out_dim: int = 64, in_dim: int = 256):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(in_dim)
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim)
        self.out_proj = nn.Conv2d(in_dim, out_dim, 1)

    def forward(self, pix_feat, masks):
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        x = self.out_proj(self.fuser(x))
        return x, sine_pos_nchw(x.shape[2], x.shape[3], x.shape[1], x.device)


# --------------------------------------------------------------------------
# memory attention (RoPE)
# --------------------------------------------------------------------------
class RoPEAttention(nn.Module):
    """Attention with the axial rotary encoding on the queries and on the
    spatial prefix of the keys (`kv_in_dim`: 64-channel memory)."""

    def __init__(self, dim: int = 256, num_heads: int = 1, kv_in_dim: int | None = None,
                 rope_k_repeat: bool = False):
        super().__init__()
        self.num_heads, self.rope_k_repeat = num_heads, rope_k_repeat
        kv = kv_in_dim or dim
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(kv, dim)
        self.v_proj = nn.Linear(kv, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, d = q.shape
        nk, h = k.shape[1], self.num_heads
        hd = d // h
        q = q.reshape(b, nq, h, hd).transpose(1, 2)
        k = k.reshape(b, nk, h, hd).transpose(1, 2)
        v = v.reshape(b, nk, h, hd).transpose(1, 2)
        side = int(round(math.sqrt(nq)))
        cos, sin = axial_rope_table(hd, side, side, q.device)
        q = apply_rope(q, cos, sin)
        n_rope = nk - num_k_exclude_rope
        if n_rope > 0:
            if self.rope_k_repeat and n_rope != nq:
                r = n_rope // nq
                cos, sin = cos.tile(r, 1), sin.tile(r, 1)
            k = torch.cat([apply_rope(k[:, :, :n_rope], cos, sin), k[:, :, n_rope:]], dim=2)
        attn = (q @ k.transpose(-1, -2) / math.sqrt(hd)).softmax(dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, nq, d))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, kv_in_dim: int = 64):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1)
        self.cross_attn_image = RoPEAttention(d_model, 1, kv_in_dim=kv_in_dim, rope_k_repeat=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, pos, num_k_exclude_rope: int = 0):
        t = self.norm1(tgt)
        tgt = tgt + self.self_attn(t, t, t)
        t = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t, memory + pos, memory,
                                          num_k_exclude_rope=num_k_exclude_rope)
        return tgt + self.linear2(F.relu(self.linear1(self.norm3(tgt))))


class MemoryAttention(nn.Module):
    """curr (B, N, 256) with positions; memory (B, M, 64) with positions,
    its last `num_obj_ptr_tokens` tokens the object pointers."""

    def __init__(self, d_model: int = 256, num_layers: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(d_model) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, curr, memory, curr_pos, memory_pos, num_obj_ptr_tokens: int = 0):
        out = curr + 0.1 * curr_pos
        for layer in self.layers:
            out = layer(out, memory, memory_pos, num_k_exclude_rope=num_obj_ptr_tokens)
        return self.norm(out)


# --------------------------------------------------------------------------
# SAM2 mask decoder
# --------------------------------------------------------------------------
class SAM2MaskDecoder(nn.Module):
    """(img_embed (B, E, g, g), dense_pe (E, g, g), sparse (B, N, E), dense
    (B, E, g, g), feat_s0 (B, E/8, 4g, 4g), feat_s1 (B, E/4, 2g, 2g)) ->
    (masks (B, 4, 4g, 4g), IoU (B, 4), mask tokens (B, 4, E), object
    logits (B, 1)). Holds the stride-4 and stride-8 projections `conv_s0`
    and `conv_s1` that encode_image applies."""

    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 2, num_mask_tokens: int = 4):
        super().__init__()
        self.num_mask_tokens = num_mask_tokens
        self.transformer = TwoWayTransformer(dim, heads, depth)
        for layer in self.transformer.layers:  # the reference's MLP names: mlp.layers.{0,1}
            layer.mlp = MLP((dim, 2048, dim))
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(num_mask_tokens, dim)
        self.obj_score_token = nn.Embedding(1, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4, eps=1e-6), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU())
        self.conv_s0 = nn.Conv2d(dim, dim // 8, 1)
        self.conv_s1 = nn.Conv2d(dim, dim // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((dim, dim, dim, dim // 8)) for _ in range(num_mask_tokens))
        self.iou_prediction_head = MLP((dim, dim, dim, num_mask_tokens), sigmoid=True)
        self.pred_obj_score_head = MLP((dim, dim, dim, 1))

    def forward(self, img_embed, dense_pe, sparse, dense, feat_s0, feat_s1):
        b, e, g = sparse.shape[0], sparse.shape[-1], img_embed.shape[-1]
        toks = torch.cat([self.obj_score_token.weight, self.iou_token.weight,
                          self.mask_tokens.weight])[None]
        queries = torch.cat([toks.expand(b, -1, -1), sparse], dim=1)
        keys = (img_embed + dense).flatten(2).transpose(1, 2)
        kpe = dense_pe.flatten(1).t()[None].expand(b, -1, -1)
        qpe = queries
        tr = self.transformer
        for layer in tr.layers:
            queries, keys = layer(queries, keys, qpe, kpe)
        q, k = queries + qpe, keys + kpe
        queries = tr.norm_final_attn(queries + tr.final_attn_token_to_image(q, k, keys))
        mask_out = queries[:, 2:2 + self.num_mask_tokens]
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = act1(ln1(dc1(keys.transpose(1, 2).reshape(b, e, g, g)) + feat_s1))
        up = act2(dc2(up) + feat_s0)
        hyper = torch.stack([m(mask_out[:, i])
                             for i, m in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper, up)
        return (masks, self.iou_prediction_head(queries[:, 1]), mask_out,
                self.pred_obj_score_head(queries[:, 0]))


# --------------------------------------------------------------------------
# SAM2 model
# --------------------------------------------------------------------------
class SAM2Model(nn.Module):
    """Promptable image and video segmentation; the methods are the entry
    points of engine/sam2.py:

      encode_image(x)          -> {feat_s0, feat_s1, feat, pos}
      sam_heads(...)           -> (masks, ious, low_res, high_res, obj_ptr, obj_logits)
      condition_features(...)  -> memory-conditioned stride-16 features
      encode_memory(...)       -> (memory, positions)
      tpos_ptr(pos_norm)       -> the object pointers' temporal encoding
    """

    def __init__(self, image_size: int = 1024, embed_dim: int = 96, num_heads: int = 1,
                 stages: Sequence[int] = (1, 2, 7, 2), global_att_blocks: Sequence[int] = (5, 7, 9),
                 window_spec: Sequence[int] = (8, 4, 14, 7),
                 window_pos_embed_bkg_spatial_size: Sequence[int] = (7, 7),
                 backbone_channel_list: Sequence[int] = (768, 384, 192, 96),
                 num_maskmem: int = 7, mem_dim: int = 64, hidden_dim: int = 256,
                 sigmoid_scale_for_mem_enc: float = 20.0, sigmoid_bias_for_mem_enc: float = -10.0):
        super().__init__()
        self.image_size, self.num_maskmem, self.mem_dim = image_size, num_maskmem, mem_dim
        self.sigmoid_scale, self.sigmoid_bias = sigmoid_scale_for_mem_enc, sigmoid_bias_for_mem_enc
        self.image_encoder = ImageEncoder(
            Hiera(embed_dim, num_heads, stages, global_att_blocks,
                  window_pos_embed_bkg_spatial_size, window_spec),
            FpnNeck(hidden_dim, backbone_channel_list), scalp=1)
        self.sam_prompt_encoder = PromptEncoder(hidden_dim, grid=image_size // 16)
        self.sam_mask_decoder = SAM2MaskDecoder(hidden_dim)
        self.memory_attention = MemoryAttention(hidden_dim)
        self.memory_encoder = MemoryEncoder(mem_dim, hidden_dim)
        self.obj_ptr_proj = MLP((hidden_dim,) * 4)
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, hidden_dim))
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(num_maskmem, 1, 1, mem_dim))

    # -- image path ------------------------------------------------------------
    def encode_image(self, x: torch.Tensor) -> dict:
        """x (B, 3, S, S) normalised -> feat_s0 (stride 4, E/8), feat_s1
        (stride 8, E/4), feat (stride 16, 256) and its sine positions."""
        out = self.image_encoder(x)
        fpn, dec = out["backbone_fpn"], self.sam_mask_decoder
        return {"feat_s0": dec.conv_s0(fpn[0]), "feat_s1": dec.conv_s1(fpn[1]),
                "feat": fpn[2], "pos": out["vision_pos_enc"][2]}

    def sam_heads(self, feat, points, labels, feat_s0, feat_s1, mask_inputs=None,
                  multimask_output: bool = False):
        """Prompt encoder and mask decoder on features (B, 256, g, g):
        points (B, P, 2) in [0, 1], labels (B, P) (-1 padding), mask_inputs
        (B, 1, 4g, 4g) logits or None. Returns (masks, ious, low_res (B, 1,
        4g, 4g), high_res (B, 1, S, S), obj_ptr (B, 256), obj_logits (B,))."""
        b = feat.shape[0]
        sparse, dense, dense_pe = self.sam_prompt_encoder(points, labels, mask_inputs)
        masks, ious, mask_toks, obj_logits = self.sam_mask_decoder(
            feat, dense_pe, sparse, dense, feat_s0, feat_s1)
        is_obj = obj_logits > 0  # (B, 1)
        masks = torch.where(is_obj[..., None, None], masks, NO_OBJ_SCORE)
        bidx = torch.arange(b, device=feat.device)
        if multimask_output:
            out_masks, out_ious = masks[:, 1:], ious[:, 1:]
            best = out_ious.argmax(dim=-1)
            low_res = out_masks[bidx, best][:, None]
            sam_tok = mask_toks[bidx, 1 + best]
        else:  # the dynamic choice: mask 0 where it is stable, else the best of the other three
            s0 = masks[:, 0]
            flat = s0.reshape(b, -1)
            area_i = (flat > 0.05).sum(-1).float()
            area_u = (flat > -0.05).sum(-1).float()
            stable = torch.where(area_u > 0, area_i / area_u, 1.0) >= 0.98
            mi = ious[:, 1:]
            best = mi.argmax(dim=-1)
            low_res = torch.where(stable[:, None, None], s0, masks[:, 1:][bidx, best])[:, None]
            out_masks = low_res
            out_ious = torch.where(stable[:, None], ious[:, :1], mi[bidx, best][:, None])
            sam_tok = mask_toks[:, 0]
        s = self.image_size
        high_res = resize_bilinear(low_res, (s, s))
        lam = is_obj.float()
        obj_ptr = lam * self.obj_ptr_proj(sam_tok) + (1 - lam) * self.no_obj_ptr
        return out_masks, out_ious, low_res, high_res, obj_ptr, obj_logits[:, 0]

    # -- memory path ------------------------------------------------------------
    def condition_features(self, feat, pos, memory, memory_pos, num_obj_ptr_tokens: int = 0):
        """The frame's stride-16 features (B, 256, g, g) with positions,
        fused with the memory bank (B, M, 64) and its positions."""
        b, c, g, _ = feat.shape
        out = self.memory_attention(feat.flatten(2).transpose(1, 2), memory,
                                    pos.flatten(2).transpose(1, 2), memory_pos,
                                    num_obj_ptr_tokens=num_obj_ptr_tokens)
        return out.transpose(1, 2).reshape(b, c, g, g)

    def no_memory_features(self, feat):
        """A conditioning frame: the no-memory embedding added."""
        return feat + self.no_mem_embed.view(1, -1, 1, 1)

    def encode_memory(self, feat, high_res_masks, obj_logits=None):
        """(features, predicted mask logits (B, 1, S, S)) -> a memory slot:
        (memory (B, 64, g, g), positions (1, 64, g, g)). `obj_logits` is
        taken as JAX's method takes it, and unused there too."""
        m = torch.sigmoid(high_res_masks) * self.sigmoid_scale + self.sigmoid_bias
        return self.memory_encoder(feat, m)

    def tpos_ptr(self, pos_norm: torch.Tensor) -> torch.Tensor:
        """(N,) time differences over their largest -> (N, mem_dim)."""
        return get_1d_sine_pe(pos_norm, self.mem_dim)

    def downsample_mask(self, m):
        """(B, 1, S, S) -> (B, 1, S/4, S/4), the prompt resolution."""
        return self.mask_downsample(m)

    def forward(self, x, points, labels):
        """Every path once: encode, no-memory conditioning, the heads, the
        memory encoder and one memory-conditioned pass. Returns (masks,
        ious, conditioned features)."""
        enc = self.encode_image(x)
        feat = self.no_memory_features(enc["feat"])
        out = self.sam_heads(feat, points, labels, enc["feat_s0"], enc["feat_s1"])
        mem, mem_pos = self.encode_memory(enc["feat"], out[3], out[5])
        memory = mem.flatten(2).transpose(1, 2)
        mpos = mem_pos.flatten(2).transpose(1, 2) + self.maskmem_tpos_enc[0, 0]
        cond = self.condition_features(enc["feat"], enc["pos"], memory, mpos.expand_as(memory))
        return out[0], out[1], cond


SAM2_CONFIGS = {
    # (embed_dim, stages, num_heads, global_att_blocks, window_spec,
    #  backbone_channel_list, window_pos_embed_bkg_spatial_size): the reference's build.py
    "sam2_t": (96, (1, 2, 7, 2), 1, (5, 7, 9), (8, 4, 14, 7), (768, 384, 192, 96), (7, 7)),
    "sam2_s": (96, (1, 2, 11, 2), 1, (7, 10, 13), (8, 4, 14, 7), (768, 384, 192, 96), (7, 7)),
    "sam2_b": (112, (2, 3, 16, 3), 2, (12, 16, 20), (8, 4, 14, 7), (896, 448, 224, 112), (14, 14)),
    "sam2_l": (144, (2, 6, 36, 4), 2, (23, 33, 43), (8, 4, 16, 8), (1152, 576, 288, 144), (7, 7)),
}


def sam2_config(variant: str) -> dict:
    """SAM2Model's keyword arguments of a variant name (sam2_t, sam2-b.pt,
    sam2.1_l, ...)."""
    key = variant.replace(".pt", "").replace("-", "_").replace("sam2.1", "sam2")
    if key not in SAM2_CONFIGS:
        raise ValueError(f"unknown SAM2 variant '{variant}'; options {sorted(SAM2_CONFIGS)}")
    ed, stages, nh, gab, ws, bcl, wbg = SAM2_CONFIGS[key]
    return {"embed_dim": ed, "stages": stages, "num_heads": nh, "global_att_blocks": gab,
            "window_spec": ws, "backbone_channel_list": bcl,
            "window_pos_embed_bkg_spatial_size": wbg}


def build_sam2(variant: str = "sam2_t", img_size: int = 1024, seed: int = 0,
               **overrides) -> SAM2Model:
    """A SAM2 model by variant, with seeded weights (f32, on the CPU): nn/sam.py's
    `init_sam` (every conv and linear U(+-1/sqrt(fan_in)), biases 0, the
    embeddings and the Fourier matrix N(0, 1)), then the no-memory and
    no-object embeddings and the temporal encodings N(0, 0.02), as flax
    initialises them; the positions stay zero and each ConvNeXt gamma 1e-6."""
    m = SAM2Model(image_size=img_size, **{**sam2_config(variant), **overrides})
    gen = torch.Generator().manual_seed(seed)
    init_sam(m, gen)
    with torch.no_grad():
        for p in (m.no_mem_embed, m.no_mem_pos_enc, m.no_obj_ptr, m.maskmem_tpos_enc):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return m.eval()
