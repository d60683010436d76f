"""Carry JAX variables of the reference package into the port's state_dict.

The port's own copy of the key rule of edgeyolo_tpu/utils/torch_convert.py
(`flax_path_to_torch_key`): flax scope `l{i}_{Type}` is `model.{i}`, a
trailing `_{digits}` group is module-list indexing (`cv2_0_1` ->
`cv2.0.1`, `mix_1_2` -> `mix.1.2`; the Segment, Pose and OBB heads'
`cv4_{level}_{j}` towers are `cv4.{level}.{j}`), and the quality head's second conv, in
either branch, sits at index 2 of its torch Sequential (`reg_conf.{i}.2`,
`one2one_reg_conf.{i}.2`), GhostBottleneck's `short_dw`/`short_pw` are
`shortcut.0`/`shortcut.1`, and a YAML's raw `nn.ConvTranspose2d` keeps its
weights on the layer (`model.{i}.weight`, no `conv_transpose` scope), as
Proto's raw upsample does (`proto.upsample.weight`). Leaves
map kernel/scale -> weight, mean/var -> running_mean/running_var (a
LayerNorm's scale and bias are its weight and bias); 2-D conv kernels go
HWIO -> OIHW, transposed-conv kernels (kh, kw, in, out) -> torch's
(in, out, kh, kw) flipped in space (JAX's torch_convert rule, inverted; keyed on the `conv_transpose` scope,
never on the shape: Proto's square 256 -> 256 kernel has a conv's shape),
1-D ones (k, in/g, out) -> (out, in/g, k), and dense kernels (in, out) ->
(out, in). A learned scale's weight (WTConv2d's `base_scale` and
`wavelet_scale_{i}`, a flax (C,) vector) is the reference's (1, C, 1, 1).
Plain parameters (`gate`, `gamma`, `scale_weights`, `prototype_base`,
AGLU's `lambd` and `kappa`) keep their name and layout.

An RT-DETR tree (a top scope `l{i}_RTDETRDecoder`) takes the reference's
torch names on top (the port's copy of JAX's `RTDETR_REWRITE_RULES`): AIFI's
`enc` scope is dropped, `input_proj_{i}_conv`/`_bn` are `input_proj.{i}.0`/
`.1`, the decoder's `layer_{i}`, `bbox_head_{i}` and `score_head_{i}` are
`decoder.layers.{i}`, `dec_bbox_head.{i}` and `dec_score_head.{i}`, an
MLP's `l{i}` is `layers.{i}`, and `denoising_class_embed` is an embedding's
`.weight`; each attention's four dense layers (`X_q`, `X_k`, `X_v`, `X_o`)
are packed into nn.MultiheadAttention's `X.in_proj_weight`,
`X.in_proj_bias` and `X.out_proj` (JAX's `pack_attention`).

A YOLO-World graph maps by the rules above (`attn.gl`, `projections.{i}`,
`query.{0,1}`, `cv4.{i}.logit_scale`).

A SAM tree (top scopes `image_encoder`, `prompt_encoder`, `mask_decoder`;
a bare TinyViT tree is handed over under `image_encoder`, as JAX's test
wraps it) takes the port's copy of JAX's SAM and TinyViT rewrite rules:
`block_{i}` are `blocks.{i}`, the patch embedding `patch_embed.proj`,
`mlp_lin{j}` `mlp.lin{j}`, the prompt encoder's Fourier matrix, embeddings
and mask stem the reference's names (`pe_layer.positional_encoding_
gaussian_matrix`, `not_a_point_embed.weight`, `mask_downscaling.{0,1,3,4,6}`),
the (4, E) point embeddings split into `point_embeddings.{i}.weight`, the
decoder's `layer_{i}` `transformer.layers.{i}` with its attentions'
`{q,k,v,out}_proj`, the upscaling `output_upscaling.{0,1,3}` (its
transposed-conv kernels flipped as above), `hyper_{i}_l{j}`
`output_hypernetworks_mlps.{i}.layers.{j}`, `iou_l{j}`
`iou_prediction_head.layers.{j}`; TinyViT's `patch_embed_{0,1}` are
`patch_embed.seq.{0,2}`, `s0_mb{j}` `layers.0.blocks.{j}`, `s{i}_blk{j}`
`layers.{i}.blocks.{j}`, `s{i}_merge` `layers.{i}.downsample`, and
`mlp_norm`/`mlp_fc{j}` `mlp.norm`/`mlp.fc{j}`.

A SAM2 tree (top scopes `image_encoder`, `memory_attention`,
`memory_encoder`, `obj_ptr_proj`, ...) takes the port's copy of JAX's
`SAM2_REWRITE_RULES` (edgeyolo_tpu/utils/torch_convert.py): the trunk's
`block_{i}` are `trunk.blocks.{i}` with `mlp.layers.{j}`, the neck's
`conv_{j}` `neck.convs.{j}.conv`, `conv_s0`/`conv_s1` and every decoder
name under `sam_mask_decoder` (`obj_score_head` is `pred_obj_score_head`),
the prompt encoder under `sam_prompt_encoder`, the memory attention's
`layer_{i}` `layers.{i}`, the memory encoder's `mask_down_{i}` and
`mask_down_ln{i}` the Sequential indices `mask_downsampler.encoder.{3i}`
and `{3i + 1}` (`mask_down_out` index 12), `fuser_{i}` `fuser.layers.{i}`,
an MLP's `l{j}` `layers.{j}`; the trunk's positions go (1, h, w, C) ->
(1, C, h, w), and the layouts are the SAM tree's.

A CLIP text tower's tree (`token_embedding`, `resblock_{i}`) becomes CLIP's
own keys: `transformer.resblocks.{i}.*`, the flax attention's query, key
and value kernels (W, H, hd) packed into `attn.in_proj_weight` (3W, W) and
their biases into `attn.in_proj_bias`, the output kernel (H, hd, W) into
`attn.out_proj.weight`, `mlp_fc`/`mlp_proj` into `mlp.c_fc`/`mlp.c_proj`;
the embeddings and the projection keep their layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_COLLECTIONS = ("params", "batch_stats")
# GhostBottleneck's shortcut convs: torch's Sequential indices
_SCOPE = {"short_dw": "shortcut_0", "short_pw": "shortcut_1"}
RTDETR_REWRITE_RULES = (
    (r"\.enc\.(ma|fc1|fc2|norm1|norm2)", r".\1"),
    (r"\.input_proj_(\d)_conv\.", r".input_proj.\1.0."),
    (r"\.input_proj_(\d)_bn\.", r".input_proj.\1.1."),
    (r"\.decoder\.layer\.(\d+)\.", r".decoder.layers.\1."),
    (r"\.decoder\.bbox_head\.(\d+)\.", r".dec_bbox_head.\1."),
    (r"\.decoder\.score_head\.(\d+)\.", r".dec_score_head.\1."),
    (r"\.l(\d)\.(weight|bias)$", r".layers.\1.\2"),
    (r"\.denoising_class_embed$", ".denoising_class_embed.weight"),
    (r"\.tgt_embed$", ".tgt_embed.weight"),
)


SAM_REWRITE_RULES = (
    (r"image_encoder\.patch_embed\.(weight|bias)$", r"image_encoder.patch_embed.proj.\1"),
    (r"\.block\.(\d+)\.", r".blocks.\1."),
    (r"mlp_lin(\d)", r"mlp.lin\1"),
    (r"prompt_encoder\.pe_gaussian$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"prompt_encoder\.not_a_point_embed$", "prompt_encoder.not_a_point_embed.weight"),
    (r"prompt_encoder\.no_mask_embed$", "prompt_encoder.no_mask_embed.weight"),
    (r"prompt_encoder\.mask_down\.0\.", "prompt_encoder.mask_downscaling.0."),
    (r"prompt_encoder\.mask_down_ln0\.", "prompt_encoder.mask_downscaling.1."),
    (r"prompt_encoder\.mask_down\.1\.", "prompt_encoder.mask_downscaling.3."),
    (r"prompt_encoder\.mask_down_ln1\.", "prompt_encoder.mask_downscaling.4."),
    (r"prompt_encoder\.mask_down\.2\.", "prompt_encoder.mask_downscaling.6."),
    (r"mask_decoder\.iou_token$", "mask_decoder.iou_token.weight"),
    (r"mask_decoder\.mask_tokens$", "mask_decoder.mask_tokens.weight"),
    (r"mask_decoder\.layer\.(\d+)\.", r"mask_decoder.transformer.layers.\1."),
    (r"\.self_attn\.(q|k|v|out)\.", r".self_attn.\1_proj."),
    (r"\.cross_t2i\.(q|k|v|out)\.", r".cross_attn_token_to_image.\1_proj."),
    (r"\.cross_i2t\.(q|k|v|out)\.", r".cross_attn_image_to_token.\1_proj."),
    (r"mask_decoder\.final_attn\.(q|k|v|out)\.",
     r"mask_decoder.transformer.final_attn_token_to_image.\1_proj."),
    (r"mask_decoder\.final_norm\.", "mask_decoder.transformer.norm_final_attn."),
    (r"mask_decoder\.upscale\.0\.", "mask_decoder.output_upscaling.0."),
    (r"mask_decoder\.upscale_ln\.", "mask_decoder.output_upscaling.1."),
    (r"mask_decoder\.upscale\.1\.", "mask_decoder.output_upscaling.3."),
    (r"mask_decoder\.hyper_(\d)_l(\d)\.", r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"mask_decoder\.iou_l(\d)\.", r"mask_decoder.iou_prediction_head.layers.\1."),
    # TinyViT (MobileSAM's encoder)
    (r"image_encoder\.patch_embed\.0\.", "image_encoder.patch_embed.seq.0."),
    (r"image_encoder\.patch_embed\.1\.", "image_encoder.patch_embed.seq.2."),
    (r"image_encoder\.s0_mb(\d+)\.", r"image_encoder.layers.0.blocks.\1."),
    (r"image_encoder\.s0_merge\.", "image_encoder.layers.0.downsample."),
    (r"image_encoder\.s(\d)_blk(\d+)\.", r"image_encoder.layers.\1.blocks.\2."),
    (r"image_encoder\.s(\d)_merge\.", r"image_encoder.layers.\1.downsample."),
    (r"\.mlp_norm\.", ".mlp.norm."),
    (r"\.mlp_fc(\d)\.", r".mlp.fc\1."),
)
_SAM_SCOPES = {"image_encoder", "prompt_encoder", "mask_decoder"}
SAM2_REWRITE_RULES = (
    (r"image_encoder\.trunk\.patch_embed\.(weight|bias)",
     r"image_encoder.trunk.patch_embed.proj.\1"),
    (r"image_encoder\.trunk\.block\.(\d+)\.", r"image_encoder.trunk.blocks.\1."),
    (r"\.mlp\.0\.", ".mlp.layers.0."),
    (r"\.mlp\.1\.", ".mlp.layers.1."),
    (r"image_encoder\.neck\.conv\.(\d+)\.", r"image_encoder.neck.convs.\1.conv."),
    (r"^conv_s0\.", "sam_mask_decoder.conv_s0."),
    (r"^conv_s1\.", "sam_mask_decoder.conv_s1."),
    (r"^prompt_encoder\.pe_gaussian$",
     "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder\.not_a_point_embed$", "sam_prompt_encoder.not_a_point_embed.weight"),
    (r"^prompt_encoder\.no_mask_embed$", "sam_prompt_encoder.no_mask_embed.weight"),
    (r"^prompt_encoder\.point_embeddings$", "sam_prompt_encoder.point_embeddings"),
    (r"^prompt_encoder\.mask_down\.0\.", "sam_prompt_encoder.mask_downscaling.0."),
    (r"^prompt_encoder\.mask_down_ln0\.", "sam_prompt_encoder.mask_downscaling.1."),
    (r"^prompt_encoder\.mask_down\.1\.", "sam_prompt_encoder.mask_downscaling.3."),
    (r"^prompt_encoder\.mask_down_ln1\.", "sam_prompt_encoder.mask_downscaling.4."),
    (r"^prompt_encoder\.mask_down\.2\.", "sam_prompt_encoder.mask_downscaling.6."),
    (r"^mask_decoder\.obj_score_token$", "sam_mask_decoder.obj_score_token.weight"),
    (r"^mask_decoder\.iou_token$", "sam_mask_decoder.iou_token.weight"),
    (r"^mask_decoder\.mask_tokens$", "sam_mask_decoder.mask_tokens.weight"),
    (r"^mask_decoder\.layer\.(\d+)\.", r"sam_mask_decoder.transformer.layers.\1."),
    (r"\.self_attn\.(q|k|v|out)\.", r".self_attn.\1_proj."),
    (r"\.cross_t2i\.(q|k|v|out)\.", r".cross_attn_token_to_image.\1_proj."),
    (r"\.cross_i2t\.(q|k|v|out)\.", r".cross_attn_image_to_token.\1_proj."),
    (r"mlp_lin1\.", "mlp.layers.0."),
    (r"mlp_lin2\.", "mlp.layers.1."),
    (r"^mask_decoder\.final_attn\.(q|k|v|out)\.",
     r"sam_mask_decoder.transformer.final_attn_token_to_image.\1_proj."),
    (r"^mask_decoder\.final_norm\.", "sam_mask_decoder.transformer.norm_final_attn."),
    (r"^mask_decoder\.upscale\.0\.", "sam_mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_ln\.", "sam_mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale\.1\.", "sam_mask_decoder.output_upscaling.3."),
    (r"^mask_decoder\.hyper\.(\d+)\.l(\d)\.",
     r"sam_mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"^mask_decoder\.iou_head\.l(\d)\.", r"sam_mask_decoder.iou_prediction_head.layers.\1."),
    (r"^mask_decoder\.obj_score_head\.l(\d)\.",
     r"sam_mask_decoder.pred_obj_score_head.layers.\1."),
    (r"^mask_decoder\.", "sam_mask_decoder."),
    (r"^memory_attention\.layer\.(\d+)\.", r"memory_attention.layers.\1."),
    (r"^memory_encoder\.mask_down\.(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder.{3 * int(m.group(1))}."),
    (r"^memory_encoder\.mask_down_ln(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder.{3 * int(m.group(1)) + 1}."),
    (r"^memory_encoder\.mask_down_out\.", "memory_encoder.mask_downsampler.encoder.12."),
    (r"^memory_encoder\.fuser\.(\d)\.", r"memory_encoder.fuser.layers.\1."),
    (r"^obj_ptr_proj\.l(\d)\.", r"obj_ptr_proj.layers.\1."),
)
_SAM2_SCOPES = {"memory_attention", "memory_encoder", "obj_ptr_proj", "maskmem_tpos_enc"}


def jax_path_to_torch_key(path: tuple[str, ...]) -> str:
    """One flax variable path (without its collection) -> the state_dict key."""
    parts = list(path)
    m = re.match(r"^l(\d+)_(.+)$", parts[0])
    if m:
        j = re.search(r"_(\d+)$", m.group(2))  # a repeated plain module: model.{i}.{j}
        parts[0] = f"model.{m.group(1)}" + (f".{j.group(1)}" if j else "")
        if m.group(2).startswith("nn_ConvTranspose2d"):  # the raw torch module: no child scope
            parts.remove("conv_transpose")
    parts = [_SCOPE.get(p, p) for p in parts]
    scopes = [re.sub(r"_(?=\d+(?:_\d+)*$)", ".", p) for p in parts[:-1]]
    key = ".".join(scopes + [_LEAF.get(parts[-1], parts[-1])])
    key = key.replace("upsample.conv_transpose.", "upsample.")  # Proto's raw ConvTranspose2d
    return re.sub(r"reg_conf\.(\d+)\.1\.", r"reg_conf.\1.2.", key)


def rtdetr_key(key: str) -> str:
    """A state_dict key under the RT-DETR rewrite rules."""
    for pat, rep in RTDETR_REWRITE_RULES:
        key = re.sub(pat, rep, key)
    return key


def pack_attention(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every complete set of X_q/X_k/X_v/X_o dense keys packed into
    nn.MultiheadAttention's in_proj_weight, in_proj_bias and out_proj."""
    sd = dict(sd)
    for k in [k for k in sd if k.endswith("_q.weight")]:
        base = k[: -len("_q.weight")]
        if not all(f"{base}_{n}.{p}" in sd for n in "qkvo" for p in ("weight", "bias")):
            continue
        sd[f"{base}.in_proj_weight"] = torch.cat([sd.pop(f"{base}_{n}.weight") for n in "qkv"])
        sd[f"{base}.in_proj_bias"] = torch.cat([sd.pop(f"{base}_{n}.bias") for n in "qkv"])
        sd[f"{base}.out_proj.weight"] = sd.pop(f"{base}_o.weight")
        sd[f"{base}.out_proj.bias"] = sd.pop(f"{base}_o.bias")
    return sd


def _sam_from_jax(flat: dict, rules=SAM_REWRITE_RULES) -> dict[str, torch.Tensor]:
    """A SAM (or, with SAM2_REWRITE_RULES, a SAM2) tree."""
    sd = {}
    for (_coll, *path), arr in flat.items():
        arr = np.asarray(arr)
        key = jax_path_to_torch_key(tuple(path))
        for pat, rep in rules:
            key = re.sub(pat, rep, key)
        if path[-1] == "kernel" and arr.ndim == 4 and re.fullmatch(r"upscale_\d", path[-2]):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # flax ConvTranspose, k = s = 2
        elif path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        elif path[-2:-1] == ["trunk"] and path[-1] in ("pos_embed", "pos_embed_window"):
            arr = arr.transpose(0, 3, 1, 2)  # Hiera's positions are the reference's NCHW
        if key.endswith("point_embeddings"):  # (4, E) -> four (1, E) embeddings
            for i, row in enumerate(arr):
                sd[f"{key}.{i}.weight"] = torch.tensor(row[None].copy())
            continue
        if key.endswith(("not_a_point_embed.weight", "no_mask_embed.weight")):
            arr = arr[None]
        sd[key] = torch.tensor(arr.copy())
    return sd


def _clip_from_jax(flat: dict) -> dict[str, torch.Tensor]:
    sd, qkv = {}, {}
    for (_coll, *path), arr in flat.items():
        arr = np.asarray(arr, np.float32)
        top, leaf = path[0], _LEAF.get(path[-1], path[-1])
        if top in ("token_embedding", "positional_embedding", "text_projection"):
            sd[top + (".weight" if top == "token_embedding" else "")] = arr
        elif top == "ln_final":
            sd[f"ln_final.{leaf}"] = arr
        else:
            pre = f"transformer.resblocks.{top.removeprefix('resblock_')}."
            if path[1] in ("ln_1", "ln_2"):
                sd[f"{pre}{path[1]}.{leaf}"] = arr
            elif path[1] in ("mlp_fc", "mlp_proj"):
                sd[f"{pre}mlp.{'c_fc' if path[1] == 'mlp_fc' else 'c_proj'}.{leaf}"] = \
                    arr.T if arr.ndim == 2 else arr
            elif path[2] == "out":  # kernel (H, hd, W) -> (W, H * hd)
                sd[f"{pre}attn.out_proj.{leaf}"] = (arr.reshape(-1, arr.shape[-1]).T
                                                     if leaf == "weight" else arr)
            else:  # query / key / value: kernel (W, H, hd) -> rows (H * hd, W) of in_proj
                qkv[pre, path[2], leaf] = (arr.reshape(arr.shape[0], -1).T if leaf == "weight"
                                           else arr.reshape(-1))
    for pre in {k[0] for k in qkv}:
        for leaf in ("weight", "bias"):
            sd[f"{pre}attn.in_proj_{leaf}"] = np.concatenate(
                [qkv[pre, p, leaf] for p in ("query", "key", "value")])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def from_jax_variables(flat: dict[tuple[str, ...], np.ndarray]) -> dict[str, torch.Tensor]:
    """{(collection, *path): array} (flax.traverse_util.flatten_dict of the
    variables, as numpy) -> {state_dict key: tensor}.

    The result has no source for the reference's frozen DFL bins, which the
    JAX package computes instead of storing; load it with strict=False.
    """
    if any(coll not in _COLLECTIONS for coll, *_ in flat):
        raise KeyError(f"unexpected variable collection in {sorted({k[0] for k in flat})}")
    tops = {k[1] for k in flat}
    if tops & _SAM2_SCOPES:
        return _sam_from_jax(flat, SAM2_REWRITE_RULES)
    if tops & _SAM_SCOPES:
        return _sam_from_jax(flat)
    if "token_embedding" in tops:
        return _clip_from_jax(flat)
    sd = {}
    for (coll, *path), arr in flat.items():
        arr = np.asarray(arr)
        if path[-1] == "kernel" and "conv_transpose" in path:  # (kh, kw, in, out), flipped
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        elif path[-1] == "weight" and re.fullmatch(r"base_scale|wavelet_scale_\d+", path[-2]):
            arr = arr.reshape(1, -1, 1, 1)
        sd[jax_path_to_torch_key(tuple(path))] = torch.tensor(arr.copy())
    if any(k[1].endswith("_RTDETRDecoder") for k in flat):  # (collection, top scope, ...)
        sd = pack_attention({rtdetr_key(k): v for k, v in sd.items()})
    return sd
