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
The tree's leaves may be numpy arrays (read as f32) or tensors of any
dtype, which keep it (a checkpoint's bf16 moments take the same map).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_LAYER_RE = re.compile(r"^layer_(\d+)$")
_MEL_CHANNELS = 65  # 64 mel bins + the playback-speed channel
_HEAD_SPLIT = ("qkv", "query", "key", "value")  # kernels [in, heads, d]
_PLAIN_LEAVES = ("cls", "pe", "contrastive_scales")


def _kernel_in_axes(modules: List[str], x: torch.Tensor) -> int:
    """How many leading axes of a flax kernel are its input: two for the
    3-D attn_proj, seq_attnpool out and audio Conv kernels, else one."""
    return 2 if x.ndim == 3 and modules[-1] in ("attn_proj", "out", "embedding") else 1


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        elif isinstance(v, torch.Tensor):
            yield prefix + (k,), v
        else:
            yield prefix + (k,), torch.tensor(np.asarray(v, dtype=np.float32))


def _torch_leaf(modules: List[str], leaf: str, x: torch.Tensor) -> Tuple[str, torch.Tensor]:
    if leaf == "kernel":
        n_in = _kernel_in_axes(modules, x)
        return "weight", x.reshape(math.prod(x.shape[:n_in]), -1).T
    if leaf == "bias":
        return "bias", x.reshape(-1)
    if leaf in ("scale", "embedding"):
        return "weight", x
    if leaf in _PLAIN_LEAVES:
        return leaf, x
    raise KeyError(f"unknown flax parameter {'/'.join(modules + [leaf])}")


def flax_entries(params) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(flax name, state_dict key, view) for every entry of the port module
    that the flax tree ``params`` (either layer layout; tensor leaves) fills:
    the '/'-joined name of its leaf in the ``layer_NN`` layout, its key, and
    the leaf in the port's layout as a view (a slice, reshape or transpose;
    nothing copied)."""
    for path, x in _flatten(params):
        *modules, leaf = path
        if "layers" in modules:  # scan layout: leading [num_layers] axis
            i = modules.index("layers")
            for n in range(x.shape[0]):
                name = "/".join(modules[:i] + [f"layer_{n:02d}"] + modules[i + 1:] + [leaf])
                yield (name, *_entry(modules[:i + 1] + [str(n)] + modules[i + 1:], leaf, x[n]))
        else:
            mods: List[str] = []
            for m in modules:
                match = _LAYER_RE.match(m)
                mods += ["layers", str(int(match.group(1)))] if match else [m]
            yield ("/".join(path), *_entry(mods, leaf, x))


def _entry(modules: List[str], leaf: str, x: torch.Tensor) -> Tuple[str, torch.Tensor]:
    name, value = _torch_leaf(modules, leaf, x)
    return ".".join(modules + [name]), value


def state_dict_from_flax(params, dtype: Optional[torch.dtype] = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """Flax tree (scan-stacked ``layers`` or ``layer_NN`` layout; numpy or
    array-like leaves, or tensors) -> state_dict of the matching port module,
    every entry a new contiguous tensor: in ``dtype`` (None: the leaf's own
    dtype), on the leaf's device (numpy leaves: the CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for _, key, value in flax_entries(params):
        if key in sd:
            raise KeyError(f"parameter {key} given twice (mixed layer layouts?)")
        value = value if dtype is None else value.to(dtype)
        sd[key] = value.clone(memory_format=torch.contiguous_format)
    return sd


def _flax_leaf(modules: List[str], name: str, x: torch.Tensor,
               size_per_head: int) -> Tuple[str, torch.Tensor]:
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
    """Port state_dict -> flax tree of f32 numpy arrays in the scan-stacked
    ``layers`` layout (``utils.checkpoint.unstack_layer_params`` gives the
    ``layer_NN`` one)."""
    return _map_tree(lambda t: t.detach().cpu().float().numpy(),
                     flax_tensors_from_state_dict(sd, size_per_head))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def flax_tensors_from_state_dict(sd: Dict[str, torch.Tensor], size_per_head: int = 64) -> Dict:
    """Port state_dict -> flax tree in the scan-stacked ``layers`` layout,
    its leaves tensors of the entries' dtype on their device (views where a
    leaf is a transpose or reshape of one entry, new tensors where per-layer
    entries are stacked)."""
    tree: Dict = {}
    stacked: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}

    def set_leaf(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, tensor in sd.items():
        *modules, name = key.split(".")
        leaf, value = _flax_leaf(modules, name, tensor.detach(), size_per_head)
        if "layers" in modules:
            i = modules.index("layers")
            path = tuple(modules[:i + 1] + modules[i + 2:] + [leaf])
            stacked.setdefault(path, {})[int(modules[i + 1])] = value
        else:
            set_leaf(modules + [leaf], value)
    for path, per_layer in stacked.items():
        set_leaf(list(path), torch.stack([per_layer[n] for n in range(len(per_layer))], 0))
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
        _, leaf = _flax_leaf(modules, name, torch.empty(tensor.shape, device="meta"),
                             size_per_head)
        shape = tuple(leaf.shape)
        if scan_layers and "layers" in modules:
            shape = (num_layers[tuple(modules[:modules.index("layers")])],) + shape
        shapes[key] = shape
    return shapes


def flax_leaf_paths(sd: Dict[str, torch.Tensor], size_per_head: int = 64,
                    scan_layers: bool = True) -> Dict[str, Tuple[str, Optional[int]]]:
    """For every state_dict entry, the '/'-joined path of the flax leaf it
    maps to and, in the scan layout, its index along that leaf's stacked
    [num_layers] axis (None for a leaf of its own). Without
    ``scan_layers`` per-layer entries have ``layer_NN`` leaves of their
    own, as the reference layout."""
    out = {}
    for key, tensor in sd.items():
        *modules, name = key.split(".")
        leaf, _ = _flax_leaf(modules, name, torch.empty(tensor.shape, device="meta"),
                             size_per_head)
        layer = None
        if "layers" in modules:
            i = modules.index("layers")
            n = int(modules[i + 1])
            if scan_layers:
                modules, layer = modules[:i + 1] + modules[i + 2:], n
            else:
                modules = modules[:i] + [f"layer_{n:02d}"] + modules[i + 2:]
        out[key] = ("/".join(modules + [leaf]), layer)
    return out


def to_flax_layout(key: str, x: torch.Tensor, size_per_head: int = 64) -> torch.Tensor:
    """One state_dict entry in its flax leaf's layout (a view; without the
    stacked layer axis)."""
    *modules, name = key.split(".")
    return _flax_leaf(modules, name, x, size_per_head)[1]


def from_flax_layout(key: str, x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_flax_layout``: a flax-layout leaf (one layer's) in
    the entry's torch layout (a view)."""
    *modules, name = key.split(".")
    leaf = {"weight": "scale" if modules and modules[-1].endswith("_ln") else (
        "embedding" if modules and modules[-1] == "Embed_0" else "kernel")}.get(name, name)
    return _torch_leaf(modules, leaf, x)[1]


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
