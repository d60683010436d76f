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
(out, in). Plain parameters
(`gate`, `gamma`, `scale_weights`, `prototype_base`) keep their name and
layout.
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
        sd[jax_path_to_torch_key(tuple(path))] = torch.tensor(arr.copy())
    return sd
