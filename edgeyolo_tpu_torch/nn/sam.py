"""Segment Anything (edgeyolo_tpu/nn/sam.py): encode an image once, prompt it many times.

- ImageEncoderViT: a 16 x 16 patch embedding, absolute positions, ViT blocks
  (pre-LayerNorm; windowed attention padded to whole windows, global
  attention at `global_idx`; decomposed relative positions in every block),
  then a 1x1 + 3x3 neck to 256 channels with LayerNorm2d after each conv.
  The blocks compute on (B, H, W, C) tokens, as the reference does.
- PromptEncoder: random Fourier features of points in [0, 1]; labels 1
  (foreground) and 0 (background) and 2, 3 (box corners) add their learned
  embedding, -1 (padding) takes the not-a-point embedding; a mask prompt goes
  through the mask stem (2x2/2 conv, LayerNorm2d, GELU, twice, then 1x1), no
  mask takes the no-mask embedding over the grid.
- MaskDecoder: the IoU token and four mask tokens with the sparse prompts as
  queries through a two-way transformer (its first layer's self-attention
  replaces the queries), upscaling x4 by two transposed convs, a
  hypernetwork MLP per mask token, and the IoU head.
- SAMModel.encode / .prompt; `build_sam` by variant (vit_b, vit_l, vit_h,
  mobile_sam with the TinyViT encoder of nn/tinyvit.py); a `sam2*` name
  raises, pointing at SAM2.

Attention is plain matmuls and a softmax in f32, as JAX computes SAM's
attention outside any kernel. LayerNorm eps follow JAX's (flax's 1e-6 but
the decoder's token norms, 1e-5). Parameter names are the reference's
state_dict keys (`image_encoder.blocks.{i}.attn.qkv`, `prompt_encoder.
point_embeddings.{i}.weight`, `mask_decoder.transformer.layers.{i}...`).
Modules take and give NCHW images and embeddings.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.transformer import layer_norm


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map, in f32."""

    def forward(self, x):
        return layer_norm(self, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _rel_coords(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Rows of the relative position table for each (query, key) pair."""
    coords = (torch.arange(q_size)[:, None] - torch.arange(k_size)[None, :] + (k_size - 1))
    return rel_pos[coords.to(rel_pos.device)]  # (q, k, hd)


def decomposed_rel_pos(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                       hw: tuple[int, int]) -> torch.Tensor:
    """MViT's decomposed relative position bias (B, nh, HW, HW) of queries
    (B, nh, HW, hd)."""
    h, w = hw
    b, nh, _, hd = q.shape
    r_q = q.reshape(b, nh, h, w, hd)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", r_q, _rel_coords(h, h, rel_h))
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", r_q, _rel_coords(w, w, rel_w))
    return (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, nh, h * w, h * w)


class Attention(nn.Module):
    """ViT attention over (B, H, W, C) tokens with decomposed relative positions."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(hd)
        attn = attn + decomposed_rel_pos(q, self.rel_pos_h, self.rel_pos_w, (h, w))
        out = torch.einsum("bhnm,bhmd->bhnd", attn.softmax(dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C), zero-padded to whole windows;
    returns the padded (H, W) too."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    """window_partition's inverse, the padding cut back to `hw`."""
    hp, wp = pad_hw
    b = wins.shape[0] // (hp // ws * (wp // ws))
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1).transpose(2, 3).reshape(b, hp, wp, -1)
    return x[:, :hw[0], :hw[1]]


class MLP(nn.Module):
    """Linears of widths `dims` with `act` between them (the reference's MLP:
    `layers.{i}`), optionally a sigmoid at the output."""

    def __init__(self, dims: Sequence[int], act=F.relu, sigmoid: bool = False):
        super().__init__()
        self.act, self.sigmoid = act, sigmoid
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            x = lin(x) if i == last else self.act(lin(x))
        return torch.sigmoid(x) if self.sigmoid else x


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.act = act
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm ViT block; window 0 attends globally over `input_size`."""

    def __init__(self, dim: int, num_heads: int, window: int, input_size: tuple[int, int]):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, (window, window) if window else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _MLPBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = layer_norm(self.norm1, x)
        if self.window:
            t, pad_hw = window_partition(t, self.window)
            t = window_unpartition(self.attn(t), self.window, pad_hw, x.shape[1:3])
        else:
            t = self.attn(t)
        x = x + t
        return x + self.mlp(layer_norm(self.norm2, x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)  # (B, H, W, C)


class ImageEncoderViT(nn.Module):
    """SAM's ViT image encoder: (B, 3, S, S) -> (B, 256, S/16, S/16)."""

    def __init__(self, img_size: int = 1024, patch: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, global_idx: Sequence[int] = (2, 5, 8, 11),
                 window: int = 14, out_chans: int = 256):
        super().__init__()
        g = img_size // patch
        self.patch_embed = PatchEmbed(patch, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, 0 if i in global_idx else window, (g, g)) for i in range(depth))
        self.neck = nn.Sequential(nn.Conv2d(dim, out_chans, 1, bias=False),
                                  LayerNorm2d(out_chans, eps=1e-6),
                                  nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
                                  LayerNorm2d(out_chans, eps=1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, : x.shape[1], : x.shape[2]]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        c = 2 * math.pi * ((2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    """Points, boxes (as two corner points) and masks -> (sparse (B, N, E),
    dense (B, E, g, g), dense positional encoding (E, g, g))."""

    def __init__(self, embed_dim: int = 256, grid: int = 64):
        super().__init__()
        self.grid = grid
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), LayerNorm2d(4, eps=1e-6), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), LayerNorm2d(16, eps=1e-6), nn.GELU(),
            nn.Conv2d(16, embed_dim, 1))

    def forward(self, points: torch.Tensor, labels: torch.Tensor,
                masks: torch.Tensor | None = None):
        """points (B, N, 2) xy in [0, 1]; labels (B, N); masks (B, 1, 4g, 4g)."""
        pe = self.pe_layer(points)
        lab = labels[..., None]
        sparse = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for li, emb in enumerate(self.point_embeddings):
            sparse = torch.where(lab == li, pe + emb.weight[0], sparse)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            dense = self.no_mask_embed.weight[0].view(1, -1, 1, 1).expand(
                points.shape[0], -1, self.grid, self.grid)
        ys = (torch.arange(self.grid, dtype=torch.float32, device=points.device) + 0.5) / self.grid
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")
        dense_pe = self.pe_layer(torch.stack([gx, gy], dim=-1)).permute(2, 0, 1)
        return sparse, dense, dense_pe


class XAttention(nn.Module):
    """Attention with the projections down-scaled by `down` (the decoder's)."""

    def __init__(self, dim: int, heads: int, down: int = 1):
        super().__init__()
        d = dim // down
        self.heads = heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, n, d = q.shape
        hd = d // self.heads
        q, k, v = (t.view(b, -1, self.heads, hd) for t in (q, k, v))
        a = (torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)).softmax(dim=-1)
        return self.out_proj(torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = XAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = XAttention(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _MLPBlock(dim, 2048, F.relu)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.norm4 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = XAttention(dim, heads, 2)

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_first_pe:  # the first layer's self-attention replaces the queries
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + qpe, keys + kpe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + qpe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(dim, heads, i == 0)
                                    for i in range(depth))
        self.final_attn_token_to_image = XAttention(dim, heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=1e-5)


class MaskDecoder(nn.Module):
    """Mask logits (B, 4, 4g, 4g) and IoU predictions (B, 4) from an image
    embedding and prompt embeddings."""

    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 2, num_masks: int = 4):
        super().__init__()
        self.num_masks = num_masks
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(num_masks, dim)
        self.transformer = TwoWayTransformer(dim, heads, depth)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4, eps=1e-6), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((dim, dim, dim, dim // 8)) for _ in range(num_masks))
        self.iou_prediction_head = MLP((dim, dim, dim, num_masks))

    def forward(self, img_embed, dense_pe, sparse, dense):
        b, e = sparse.shape[0], sparse.shape[-1]
        toks = torch.cat([self.iou_token.weight, self.mask_tokens.weight])[None]
        queries = torch.cat([toks.expand(b, -1, -1), sparse], dim=1)
        g = img_embed.shape[-1]
        keys = (img_embed + dense).flatten(2).transpose(1, 2)
        kpe = dense_pe.flatten(1).t()[None].expand(b, -1, -1)
        qpe = queries  # the tokens are their own positional encoding
        tr = self.transformer
        for layer in tr.layers:
            queries, keys = layer(queries, keys, qpe, kpe)
        q, k = queries + qpe, keys + kpe
        queries = tr.norm_final_attn(queries + tr.final_attn_token_to_image(q, k, keys))
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, e, g, g))
        hyper = torch.stack([m(queries[:, 1 + i])
                             for i, m in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper, up)
        return masks, self.iou_prediction_head(queries[:, 0])


class SAMModel(nn.Module):
    """The promptable pipeline: `encode` once, `prompt` many times."""

    def __init__(self, img_size: int = 1024, encoder_dim: int = 768, encoder_depth: int = 12,
                 encoder_heads: int = 12, global_idx: Sequence[int] = (2, 5, 8, 11),
                 mobile: bool = False):
        super().__init__()
        self.img_size, self.mobile = img_size, mobile
        if mobile:
            from edgeyolo_tpu_torch.nn.tinyvit import TinyViT

            self.image_encoder = TinyViT()
        else:
            self.image_encoder = ImageEncoderViT(img_size, dim=encoder_dim, depth=encoder_depth,
                                                 num_heads=encoder_heads, global_idx=global_idx)
        self.prompt_encoder = PromptEncoder(grid=img_size // 16)
        self.mask_decoder = MaskDecoder()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)

    def prompt(self, img_embed, points, labels, masks=None):
        sparse, dense, dense_pe = self.prompt_encoder(points, labels, masks)
        return self.mask_decoder(img_embed, dense_pe, sparse, dense)

    def forward(self, x, points, labels):
        return self.prompt(self.encode(x), points, labels)


_VARIANTS = {
    # dim, depth, heads, global attention indices (the reference's build.py)
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}


def init_sam(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights: the detection models' `init_weights` (every conv,
    transposed conv and linear weight U(+-1/sqrt(fan_in)), JAX's KINIT, their
    biases 0), then the embeddings and the Fourier matrix N(0, 1); LayerNorm,
    BatchNorm, the positions and the relative and attention-bias tables keep
    their constructor values (ones, zeros)."""
    from edgeyolo_tpu_torch.nn.tasks import init_weights

    init_weights(model, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, PositionEmbeddingRandom):
                g = m.positional_encoding_gaussian_matrix
                g.copy_(torch.randn(g.shape, generator=generator))
    return model


def build_sam(variant: str = "vit_b", img_size: int = 1024, seed: int = 0) -> SAMModel:
    """A SAM model by encoder variant, with seeded weights (f32, on the CPU)."""
    if variant.startswith("sam2"):
        raise ValueError("SAM2 is not SAM: build it with build_sam2() / SAM2 (nn/sam2.py)")
    if variant in {"mobile_sam", "mobile"}:
        m = SAMModel(img_size=img_size, mobile=True)
    else:
        dim, depth, heads, gidx = _VARIANTS[variant]
        m = SAMModel(img_size, dim, depth, heads, gidx)
    return init_sam(m, torch.Generator().manual_seed(seed)).eval()
