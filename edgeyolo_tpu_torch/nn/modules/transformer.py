"""RT-DETR's transformer modules, NCHW at the graph boundary
(edgeyolo_tpu/nn/modules/transformer.py).

- MultiheadAttention: torch's packed layout (`in_proj_weight` (3C, C),
  `in_proj_bias`, `out_proj`), computed as JAX's `_mha`: per-head scores
  divided by sqrt(head dim), a boolean mask (True = blocked) filled with
  -1e9 before the softmax, which runs in f32.
- MLP: a ReLU MLP (`layers.{i}`), its input cast to its weights' dtype.
- TransformerEncoderLayer / AIFI: the post-norm encoder layer (exact GELU)
  and RT-DETR's intra-scale interaction on the stride-32 map, with JAX's
  "transposed" 2-D sin-cos pairing kept as it is: tokens are H-major, the
  grid w-major.
- RepC3: two 1x1 ConvBNs, n RepConvs on the first, summed with the second.
- ms_deform_sample / MSDeformAttn: multi-scale deformable attention. Each
  level samples its map at loc * size - 0.5, bilinearly, zero outside the
  map, by index gathers as JAX's `tap` takes them (one gather for every
  level's four taps): its backward is a scatter-add, which has a
  deterministic form on the card (F.grid_sample's backward has none).
  Reference points come as (B, Lq, L, 2) points or (B, Lq, 4) boxes, whose
  offsets scale with the box.
- DeformableTransformerDecoderLayer / DeformableTransformerDecoder: self
  attention, deformable cross attention and a ReLU FFN, post-norm; six
  layers refine the boxes iteratively, the reference handed to the next
  layer detached in training; in eval the decoder returns at `eval_idx`.

Precision: LayerNorm runs in f32 and returns the input dtype. The reference
boxes, their inverse sigmoid, the refined boxes, the sampling offsets,
attention weights and locations, and the bilinear weights are f32 whatever
the model dtype (in bf16 a location at 80 px spacing would move by about
0.3 px); the linear layers' outputs and the sampled values keep the model
dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.conv import ConvBN
from edgeyolo_tpu_torch.nn.modules.gelan import RepConv
from edgeyolo_tpu_torch.utils import uniform_


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in f32, back to the input dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention in nn.MultiheadAttention's parameter layout."""

    def __init__(self, c: int, num_heads: int = 8):
        super().__init__()
        self.c, self.num_heads = c, num_heads
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(3 * c, c)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """q, k and v kernels U(+-1/sqrt(C)) as three dense layers, biases 0."""
        uniform_(self.in_proj_weight, self.c ** -0.5, generator)
        self.in_proj_bias.zero_()

    def forward(self, q, k, v, mask: torch.Tensor | None = None):
        b, nq, c = q.shape
        h = self.num_heads
        w, bias = self.in_proj_weight, self.in_proj_bias
        qp, kp, vp = (F.linear(t, w[i * c:(i + 1) * c], bias[i * c:(i + 1) * c])
                      .view(b, t.shape[1], h, c // h).transpose(1, 2)
                      for i, t in enumerate((q, k, v)))
        attn = (qp @ kp.transpose(-1, -2)) / math.sqrt(c // h)
        if mask is not None:
            attn = attn.masked_fill(mask, -1e9)
        attn = attn.float().softmax(dim=-1).to(vp.dtype)
        return self.out_proj((attn @ vp).transpose(1, 2).reshape(b, nq, c))


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between them."""

    def __init__(self, c1: int, hidden: int, c2: int, num_layers: int = 2):
        super().__init__()
        dims = [c1] + [hidden] * (num_layers - 1) + [c2]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        x = x.to(self.layers[0].weight.dtype)
        for i, m in enumerate(self.layers):
            x = m(x) if i == len(self.layers) - 1 else F.relu(m(x))
        return x


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: attention, add & norm, GELU FFN, add & norm."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiheadAttention(c1, num_heads)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm1 = nn.LayerNorm(c1, eps=1e-5)
        self.norm2 = nn.LayerNorm(c1, eps=1e-5)

    def encode(self, src: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        """src (B, N, C); pos broadcastable to it."""
        q = src if pos is None else src + pos.to(src.dtype)
        src = layer_norm(self.norm1, src + self.ma(q, q, src))
        ff = self.fc2(F.gelu(self.fc1(src)))
        return layer_norm(self.norm2, src + ff)

    def forward(self, src, pos=None):
        return self.encode(src, pos)


def sincos_embed(w: int, h: int, dim: int, temperature: float = 10000.0,
                 device=None) -> torch.Tensor:
    """(1, w * h, dim) f32: sin and cos of the w index, then of the h index,
    over a w-major grid (JAX's AIFI.sincos_embed)."""
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                            torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device)
                                   / pos_dim))
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)[None]


class AIFI(TransformerEncoderLayer):
    """The encoder layer over the tokens of an NCHW map, with 2-D sin-cos positions."""

    def forward(self, x):
        b, c, h, w = x.shape
        pos = sincos_embed(w, h, c, device=x.device)  # w-major against H-major tokens: JAX's
        tokens = self.encode(x.flatten(2).transpose(1, 2), pos)
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class RepC3(nn.Module):
    """Rep-style C3 of the RT-DETR neck."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_, 3, 1) for _ in range(n)))
        self.cv3 = ConvBN(c_, c2, 1) if c_ != c2 else None

    def forward(self, x):
        y = self.m(self.cv1(x)) + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


def ms_deform_sample(value: torch.Tensor, shapes: Sequence[tuple[int, int]],
                     loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling.

    value (B, Lv, H, D), the levels' maps flattened row-major one after the
    other; loc (B, Lq, H, L, P, 2) in [0, 1] (x, y); weights (B, Lq, H, L, P).
    Returns (B, Lq, H * D) in value's dtype: per head the weighted sum over
    levels and points of the bilinear samples, taps outside a map counting 0.
    Every level's four taps are one gather over the flattened maps, their
    bilinear and attention weights one f32 product.
    """
    b, _, nh, d = value.shape
    lq, nl, npts = loc.shape[1], loc.shape[3], loc.shape[4]
    dev = loc.device
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    start = torch.tensor([0] + [h * w for h, w in shapes][:-1], device=dev).cumsum(0)
    xy = loc.float() * size[:, None, :] - 0.5  # (B, Lq, H, L, P, 2)
    xy0 = xy.floor()
    f = xy - xy0
    fx, fy = f[..., 0:1], f[..., 1:2]
    # taps (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1) on a last axis
    bil = torch.cat([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], dim=-1)
    xi = xy0[..., 0:1].long() + torch.tensor([0, 1, 0, 1], device=dev)
    yi = xy0[..., 1:2].long() + torch.tensor([0, 0, 1, 1], device=dev)
    w, h = (size[:, i, None, None].long() for i in (0, 1))  # (L, 1, 1)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = start[:, None, None] + yi.clamp(min=0).minimum(h - 1) * w + xi.clamp(min=0).minimum(
        w - 1)  # (B, Lq, H, L, P, 4)
    wt = bil * valid * weights.float()[..., None]
    k = nl * npts * 4
    g = value.transpose(1, 2).gather(
        2, idx.transpose(1, 2).reshape(b, nh, lq * k, 1).expand(-1, -1, -1, d))
    out = (g.view(b, nh, lq, k, d) * wt.transpose(1, 2).reshape(b, nh, lq, k, 1)).sum(dim=3)
    return out.transpose(1, 2).reshape(b, lq, nh * d).to(value.dtype)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (Deformable DETR)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = (d_model, n_levels, n_heads,
                                                                    n_points)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """JAX's: offsets and attention-weight kernels 0; the offsets' bias one
        unit ray per head (cos, sin over the larger of the two), times the
        point's rank 1..P; value and output projections xavier-uniform."""
        nh, nl, npts = self.n_heads, self.n_levels, self.n_points
        self.sampling_offsets.weight.zero_()
        thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().amax(-1, keepdim=True)
        grid = grid[:, None, None, :].repeat(1, nl, npts, 1)
        scale = torch.arange(1, npts + 1, dtype=torch.float32)[None, None, :, None]
        self.sampling_offsets.bias.copy_((grid * scale).reshape(-1))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        for m in (self.value_proj, self.output_proj):
            uniform_(m.weight, (6.0 / sum(m.weight.shape)) ** 0.5, generator)
            m.bias.zero_()

    def forward(self, query, refer_bbox, value, shapes: Sequence[tuple[int, int]]):
        """query (B, Lq, C); refer_bbox (B, Lq, L, 2) points or (B, Lq, 4)
        boxes, normalised; value (B, Lv, C) over the levels' `shapes`."""
        b, lq = query.shape[:2]
        nh, nl, npts = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).view(b, value.shape[1], nh, self.d_model // nh)
        off = self.sampling_offsets(query).float().view(b, lq, nh, nl, npts, 2)
        aw = self.attention_weights(query).float().view(b, lq, nh, nl * npts).softmax(dim=-1)
        refer = refer_bbox.float()
        if refer.shape[-1] == 2:
            norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                                device=query.device)
            loc = refer[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        else:
            loc = (refer[:, :, None, None, None, :2]
                   + off / npts * refer[:, :, None, None, None, 2:] * 0.5)
        out = ms_deform_sample(v, shapes, loc, aw.view(b, lq, nh, nl, npts))
        return self.output_proj(out)


class DeformableTransformerDecoderLayer(nn.Module):
    """Self attention, deformable cross attention and a ReLU FFN, each added
    and normed."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 4, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos=None, attn_mask=None):
        q = embed if query_pos is None else embed + query_pos
        embed = layer_norm(self.norm1, embed + self.self_attn(q, q, embed, attn_mask))
        q = embed if query_pos is None else embed + query_pos
        embed = layer_norm(self.norm2, embed + self.cross_attn(q, refer_bbox, feats, shapes))
        ff = self.linear2(F.relu(self.linear1(embed)))
        return layer_norm(self.norm3, embed + ff)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class DeformableTransformerDecoder(nn.Module):
    """ndl decoder layers with iterative box refinement; the box and score
    heads and the query position MLP belong to the caller (RTDETRDecoder)."""

    def __init__(self, hd: int = 256, ndl: int = 6, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 3, n_points: int = 4, eval_idx: int = -1):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableTransformerDecoderLayer(hd, n_heads, d_ffn, n_levels, n_points)
            for _ in range(ndl))
        self.eval_idx = eval_idx if eval_idx >= 0 else ndl + eval_idx

    def forward(self, embed, refer_bbox, feats, shapes, bbox_head, score_head, pos_head,
                attn_mask=None):
        """embed (B, T, C); refer_bbox (B, T, 4) logits, f32. Returns the last
        refined boxes (f32, normalised cxcywh) and score logits, and each
        layer's."""
        output = embed
        boxes, scores = [], []
        refer = refer_bbox.float().sigmoid()
        for i, layer in enumerate(self.layers):
            output = layer(output, refer, feats, shapes, pos_head(refer), attn_mask)
            refined = (bbox_head[i](output).float() + inverse_sigmoid(refer)).sigmoid()
            boxes.append(refined)
            scores.append(score_head[i](output))
            if not self.training and i == self.eval_idx:
                break
            refer = refined.detach() if self.training else refined
        return boxes[-1], scores[-1], boxes, scores
