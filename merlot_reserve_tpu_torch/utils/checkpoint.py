"""Layer-layout converters for flax parameter trees held as numpy arrays.

The reference checkpoints store one ``layer_NN`` subtree per transformer
layer; the JAX package's scan-over-layers models store one ``layers``
subtree whose leaves are stacked along a leading [num_layers] axis.
"""

from __future__ import annotations

import re

import numpy as np

_LAYER_RE = re.compile(r"^layer_(\d+)$")


def stack_layer_params(tree):
    """'layer_NN' subtrees -> one stacked 'layers' subtree, recursively."""
    if not isinstance(tree, dict):
        return tree
    layer_keys = sorted((k for k in tree if _LAYER_RE.match(k)),
                        key=lambda k: int(_LAYER_RE.match(k).group(1)))
    out = {k: stack_layer_params(v) for k, v in tree.items() if not _LAYER_RE.match(k)}
    if layer_keys:
        out["layers"] = _stack([tree[k] for k in layer_keys])
    return out


def _stack(subtrees):
    first = subtrees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in subtrees]) for k in first}
    return np.stack([np.asarray(t) for t in subtrees], 0)


def unstack_layer_params(tree):
    """Inverse of ``stack_layer_params``: 'layers' ([L, ...]) -> 'layer_NN'."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, dict):
            num_layers = _first_leaf(v).shape[0]
            for i in range(num_layers):
                out[f"layer_{i:02d}"] = _index(v, i)
        else:
            out[k] = unstack_layer_params(v)
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
