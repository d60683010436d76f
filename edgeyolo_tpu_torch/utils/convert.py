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


def from_jax_variables(flat: dict[tuple[str, ...], np.ndarray]) -> dict[str, torch.Tensor]:
    """{(collection, *path): array} (flax.traverse_util.flatten_dict of the
    variables, as numpy) -> {state_dict key: tensor}.

    The result has no source for the reference's frozen DFL bins, which the
    JAX package computes instead of storing; load it with strict=False.
    """
    sd = {}
    for (coll, *path), arr in flat.items():
        if coll not in _COLLECTIONS:
            raise KeyError(f"unexpected variable collection '{coll}'")
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
