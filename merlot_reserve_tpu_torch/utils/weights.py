"""Map between flax parameter trees (numpy leaves) and the port's state_dict.

Module names are the same on both sides; what differs is the leaf layout:

  flax                                        torch
  Dense kernel [in, out]                      Linear weight [out, in]
  DenseGeneral qkv kernel [H, 3*heads, d]     Linear weight [3*heads*d, H]
    and its bias [3*heads, d]                   bias [3*heads*d]
  attn_proj kernel [heads, d, H]              Linear weight [H, heads*d]
  seq_attnpool query/key/value [H, heads, d]  Linear weight [heads*d, H]
  seq_attnpool out kernel [heads, d, H]       Linear weight [H, heads*d]
  audio Conv kernel [patch, 65, H]            Linear weight [H, patch*65]
  LayerNorm scale / Embed embedding           weight
  layers/... stacked [num_layers, ...]        layers.<n>....   (scan layout)
  layer_NN/...                                layers.<n>....   (reference layout)

Every conversion is a transpose or reshape, so a round trip is bit-exact.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_LAYER_RE = re.compile(r"^layer_(\d+)$")
_MEL_CHANNELS = 65  # 64 mel bins + the playback-speed channel
_HEAD_SPLIT = ("qkv", "query", "key", "value")  # kernels [in, heads, d]
_PLAIN_LEAVES = ("cls", "pe", "contrastive_scales")


def _kernel_in_axes(modules: List[str], x: np.ndarray) -> int:
    """How many leading axes of a flax kernel are its input: two for the
    3-D attn_proj, seq_attnpool out and audio Conv kernels, else one."""
    return 2 if x.ndim == 3 and modules[-1] in ("attn_proj", "out", "embedding") else 1


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _torch_leaf(modules: List[str], leaf: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        n_in = _kernel_in_axes(modules, x)
        return "weight", x.reshape(int(np.prod(x.shape[:n_in])), -1).T
    if leaf == "bias":
        return "bias", x.reshape(-1)
    if leaf in ("scale", "embedding"):
        return "weight", x
    if leaf in _PLAIN_LEAVES:
        return leaf, x
    raise KeyError(f"unknown flax parameter {'/'.join(modules + [leaf])}")


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """Flax tree (scan-stacked ``layers`` or ``layer_NN`` layout, numpy or
    array-like leaves) -> f32 CPU state_dict of the matching port module."""
    sd: Dict[str, torch.Tensor] = {}

    def put(modules, leaf, x):
        name, value = _torch_leaf(modules, leaf, x)
        key = ".".join(modules + [name])
        if key in sd:
            raise KeyError(f"parameter {key} given twice (mixed layer layouts?)")
        sd[key] = torch.from_numpy(np.array(value, order="C"))

    for path, x in _flatten(params):
        *modules, leaf = path
        if "layers" in modules:  # scan layout: leading [num_layers] axis
            i = modules.index("layers")
            for n in range(x.shape[0]):
                put(modules[:i + 1] + [str(n)] + modules[i + 1:], leaf, x[n])
        else:
            mods: List[str] = []
            for m in modules:
                match = _LAYER_RE.match(m)
                mods += ["layers", str(int(match.group(1)))] if match else [m]
            put(mods, leaf, x)
    return sd


def _flax_leaf(modules: List[str], name: str, x: np.ndarray,
               size_per_head: int) -> Tuple[str, np.ndarray]:
    mod = modules[-1] if modules else ""
    if name == "weight":
        if mod.endswith("_ln"):
            return "scale", x
        if mod == "Embed_0":
            return "embedding", x
        kernel = x.T  # [in, out]
        if mod in _HEAD_SPLIT:
            return "kernel", kernel.reshape(kernel.shape[0], -1, size_per_head)
        if mod == "attn_proj" or (mod == "out" and "seq_attnpool" in modules):
            return "kernel", kernel.reshape(-1, size_per_head, kernel.shape[1])
        if mod == "embedding" and "audio_encoder" in modules:  # the Conv [patch, 65, H]
            return "kernel", kernel.reshape(-1, _MEL_CHANNELS, kernel.shape[1])
        return "kernel", kernel
    if name == "bias":
        return "bias", x.reshape(-1, size_per_head) if mod in _HEAD_SPLIT else x
    if name in _PLAIN_LEAVES:
        return name, x
    raise KeyError(f"unknown state_dict entry {'.'.join(modules + [name])}")


def flax_from_state_dict(sd: Dict[str, torch.Tensor], size_per_head: int = 64) -> Dict:
    """Port state_dict -> flax tree in the scan-stacked ``layers`` layout
    (``utils.checkpoint.unstack_layer_params`` gives the ``layer_NN`` one)."""
    tree: Dict = {}
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}

    def set_leaf(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, tensor in sd.items():
        *modules, name = key.split(".")
        leaf, value = _flax_leaf(modules, name, tensor.detach().cpu().float().numpy(),
                                 size_per_head)
        if "layers" in modules:
            i = modules.index("layers")
            path = tuple(modules[:i + 1] + modules[i + 2:] + [leaf])
            stacked.setdefault(path, {})[int(modules[i + 1])] = value
        else:
            set_leaf(modules + [leaf], value)
    for path, per_layer in stacked.items():
        set_leaf(list(path), np.stack([per_layer[n] for n in range(len(per_layer))], 0))
    return tree


def flax_leaf_shapes(sd: Dict[str, torch.Tensor], size_per_head: int = 64,
                     scan_layers: bool = True) -> Dict[str, Tuple[int, ...]]:
    """The shape of the flax leaf that each state_dict entry maps to. With
    ``scan_layers`` (the JAX package's default layout) a per-layer entry's
    leaf carries the stacked [num_layers] axis in front."""
    num_layers: Dict[Tuple[str, ...], int] = {}
    for key in sd:
        *modules, _ = key.split(".")
        if "layers" in modules:
            i = modules.index("layers")
            stack = tuple(modules[:i])
            num_layers[stack] = max(num_layers.get(stack, 0), int(modules[i + 1]) + 1)
    shapes = {}
    for key, tensor in sd.items():
        *modules, name = key.split(".")
        _, leaf = _flax_leaf(modules, name, np.empty(tuple(tensor.shape), np.bool_),
                             size_per_head)
        shape = leaf.shape
        if scan_layers and "layers" in modules:
            shape = (num_layers[tuple(modules[:modules.index("layers")])],) + shape
        shapes[key] = shape
    return shapes


def load_flax_params(model: torch.nn.Module, params) -> None:
    """Copy a flax tree into ``model``. Raises on a missing, unused or
    mis-shaped parameter."""
    sd = state_dict_from_flax(params)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(sd))
    unused = sorted(set(sd) - set(expected))
    shapes = sorted(k for k in set(sd) & set(expected) if sd[k].shape != expected[k].shape)
    if missing or unused or shapes:
        raise ValueError(f"flax params do not fit the model: missing {missing}, "
                         f"unused {unused}, wrong shape {shapes}")
    model.load_state_dict(sd, strict=True)
