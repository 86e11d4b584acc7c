"""Serving artifacts: ``torch.export``ed programs and parameters on disk.

The port of ``merlot_reserve_tpu/export.py``. ``export_serving_artifact``
freezes the zero-shot serving surface once into a directory that a serving
host loads and runs without the model code:

  manifest.json     versions, platform, shapes, the parameters' order
  embed_video.pt2   ``torch.export.save`` of ``batch_embed_video``
  label_space.pt2   ``torch.export.save`` of ``embed_text_spans_only``
  params.msgpack    the f16-compressed flax parameter tree (``utils/msgpack.py``,
                    ``utils.checkpoint.compress_state``): the JAX package's
                    file, readable by either package

As in the JAX package the parameters are an input of each exported call,
not part of it, so the .pt2 files hold no weights. The programs take the
model's parameters (``torch.func.functional_call``), then the batch; the
manifest's ``param_order`` names each by its flax leaf in the ``layer_NN``
layout ('/'-joined), and the loader maps the tree in params.msgpack to
them once (``utils.weights.flax_entries``), so a call re-maps nothing.
The joint and span transformers' attention is the operator
``merlot_reserve_torch::flash_fwd`` (``ops/attention.py``), which launches
the hand-written ``csrc/flash_fwd.cu`` on the card; the loader imports
that module to register it.

One platform per artifact, unlike the JAX package's one artifact for
("tpu", "cpu"): the attention policy 'auto' traces another graph on each
device. The manifest's ``platforms`` is ``["cuda"]`` by default, or
``["cpu"]``; ``load_serving_artifact`` raises on any other device.

Artifacts are fixed-shape, as ``serving.VideoEmbedService`` is: requests pad
up to the exported batch, options up to the exported count. An artifact is
tied to the torch version that wrote it (the manifest's ``torch_version``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.func import functional_call

from merlot_reserve_tpu_torch.ops import attention as _attention  # noqa: F401 (registers flash_fwd)
from merlot_reserve_tpu_torch.serving import FIELDS, embed_in_batches, stage_batch
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.checkpoint import compress_state, decompress_state
from merlot_reserve_tpu_torch.utils.device import resolve_device
from merlot_reserve_tpu_torch.utils.profiling import log_compile
from merlot_reserve_tpu_torch.utils.weights import flax_entries

ARTIFACT_FORMAT_VERSION = 1


class _Method(torch.nn.Module):
    def __init__(self, model, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


class _FlatCall(torch.nn.Module):
    """``model.<method>`` as a function of (the model's parameters, in the
    order of ``keys``, then the method's inputs). The model is held outside
    the module's registry, so the exported program lifts none of its own
    tensors."""

    def __init__(self, model, method: str, keys: Sequence[str]):
        super().__init__()
        self.__dict__["call"] = _Method(model, method)
        self.keys = list(keys)

    def forward(self, *args):
        n = len(self.keys)
        return functional_call(self.call, {f"model.{k}": t for k, t in zip(self.keys, args[:n])},
                               args[n:], strict=True)


def _erase_metadata_asserts(program) -> None:
    """Drop the ``aten._assert_tensor_metadata`` node that ``torch.export``
    puts after each ``.to`` (727 in the base model's embed program): the
    inputs' dtypes and devices are fixed by the artifact, and each assert is
    a host dispatch on every call (``scripts/profile_torch_export.py``)."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    program.graph_module.recompile()


def _tensor_tree(tree):
    """The flax tree with CPU tensor leaves, as ``utils/msgpack.py`` writes it."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.as_tensor(np.array(tree, np.float32))


def export_serving_artifact(model, params: Dict, example_video: Dict, path: str,
                            batch_size: int = 8, num_options: int = 64,
                            device="cuda") -> Dict:
    """Write the serving artifact of ``model`` with ``params`` to ``path``.

    :param model: a ``MerlotReserve`` (its own weights are not used: one built
        on the "meta" device holds none)
    :param params: the flax parameter tree (numpy or tensor leaves, the
        model's layer layout), as the JAX package's function takes it
    :param example_video: one ``preprocess_video`` output (images,
        audio_clips, tokens, subseg_idxs): fixes the exported shapes
    :param num_options: exported label-space rows; callers pad options up
    :param device: the one platform of the artifact: the card unless the
        caller passes "cpu"
    :returns: the manifest dict
    """
    device = resolve_device(device)
    tree = _tensor_tree(params)
    entries = list(flax_entries(tree))
    expected = {k: p.shape for k, p in model.named_parameters()}
    given = {key: view.shape for _, key, view in entries}
    if given != expected:
        wrong = sorted(k for k in set(given) & set(expected) if given[k] != expected[k])
        raise ValueError(f"params do not fit the model: missing "
                         f"{sorted(set(expected) - set(given))}, unused "
                         f"{sorted(set(given) - set(expected))}, wrong shape {wrong}")
    keys = [key for _, key, _ in entries]
    flat = [view.to(device, torch.float32).contiguous() for _, _, view in entries]
    batch = dict(zip(FIELDS, stage_batch([example_video], batch_size, device)))
    span_len = int(model.config.text_span_length)  # CLS is added inside
    opts = torch.zeros((num_options, span_len), dtype=torch.int64, device=device)

    os.makedirs(path, exist_ok=True)
    with torch.no_grad():
        for method, inputs, file in (
                ("batch_embed_video", tuple(batch.values()), "embed_video.pt2"),
                ("embed_text_spans_only", (opts,), "label_space.pt2")):
            t0 = time.perf_counter()
            program = torch.export.export(_FlatCall(model, method, keys),
                                          tuple(flat) + inputs, strict=False)
            log_compile("export", f"{method} -> {file}", "traced", time.perf_counter() - t0)
            program.example_inputs = None  # they hold the parameters
            _erase_metadata_asserts(program)
            torch.export.save(program, os.path.join(path, file))
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        msgpack.dump(compress_state(tree), f)
    manifest = {
        "format_version": ARTIFACT_FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": [device.type],
        "batch_size": batch_size,
        "num_options": num_options,
        "span_length": span_len,
        "hidden_size": int(model.config.hidden_size),
        "input_shapes": {k: list(v.shape) for k, v in batch.items()},
        "input_dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in batch.items()},
        "param_order": [name for name, _, _ in entries],
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


@dataclass
class ExportedVideoService:
    """Serving handle over a loaded artifact: no model code, no re-trace.

    The contract of ``serving.VideoEmbedService``: a fixed batch shape,
    requests padded up to it, the parameters on the device, uploaded once at
    load. Unlike it, an empty request returns zeros of shape [0, L, H]: the
    artifact knows its shapes.
    """

    manifest: Dict
    params: List[torch.Tensor]
    device: torch.device
    # the exported programs' forward: (*params, *inputs) on the device. The
    # parameters are checked against the programs once, at load, and the
    # batches by embed and label_space; forward skips the unlifted module's
    # check of every input on every call (scripts/profile_torch_export.py)
    embed_program: Callable
    label_program: Callable

    def embed(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """Up to ``batch_size`` preprocessed videos -> [N, L, H] f32."""
        m = self.manifest
        bs = m["batch_size"]
        if not video_pres:  # the same rank as a non-empty result
            return np.zeros((0, m["input_shapes"]["tokens"][1], m["hidden_size"]), np.float32)
        if len(video_pres) > bs:
            raise ValueError(f"{len(video_pres)} videos > batch size {bs}: use embed_stream")
        with torch.inference_mode():
            batch = stage_batch(video_pres, bs, self.device)
            for k, x in zip(FIELDS, batch):
                if list(x.shape) != m["input_shapes"][k]:
                    raise ValueError(f"{k} {list(x.shape)} != the exported "
                                     f"{m['input_shapes'][k]}")
            out = self.embed_program(*self.params, *batch)
            return out[:len(video_pres)].float().cpu().numpy()

    def embed_stream(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """Any number of videos, batch by batch -> [N, L, H]."""
        if not video_pres:
            return self.embed([])
        return embed_in_batches(self.embed, video_pres, self.manifest["batch_size"])

    def label_space(self, option_tokens: np.ndarray) -> np.ndarray:
        """[n, span_len] padded option tokens -> [n, H] unit span embeddings."""
        m = self.manifest
        n = option_tokens.shape[0]
        if n > m["num_options"] or option_tokens.shape[1] != m["span_length"]:
            raise ValueError(f"options {tuple(option_tokens.shape)} do not fit the exported "
                             f"[{m['num_options']}, {m['span_length']}]")
        opts = np.zeros((m["num_options"], m["span_length"]), np.int64)
        opts[:n] = option_tokens
        with torch.inference_mode():
            out = self.label_program(*self.params, torch.from_numpy(opts).to(self.device))
            return out[:n].float().cpu().numpy()


def load_serving_artifact(path: str, device="cuda") -> ExportedVideoService:
    """Load an artifact written by :func:`export_serving_artifact` on
    ``device`` (the card unless the caller passes "cpu"), which must be the
    artifact's platform. Imports no model code: the computation comes from
    the exported programs, their attention from the registered
    ``flash_fwd`` operator."""
    device = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != ARTIFACT_FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest['format_version']}, this loader reads "
                         f"{ARTIFACT_FORMAT_VERSION}")
    if manifest["platforms"] != [device.type]:
        raise ValueError(f"the artifact at {path} was exported for {manifest['platforms']}, "
                         f"not {device.type!r}: export it again on that device")
    programs = [torch.export.load(os.path.join(path, f))
                for f in ("embed_video.pt2", "label_space.pt2")]
    tree = decompress_state(msgpack.load(os.path.join(path, "params.msgpack")))
    views = {name: view for name, _, view in flax_entries(tree)}
    if sorted(views) != sorted(manifest["param_order"]):
        raise ValueError("params.msgpack does not hold the manifest's parameters")
    params = [views[name].to(device, torch.float32).contiguous()
              for name in manifest["param_order"]]
    for program in programs:
        inputs = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"]
        for name, p, want in zip(manifest["param_order"], params, inputs):
            if p.shape != want.shape or p.dtype != want.dtype:
                raise ValueError(f"parameter {name}: {tuple(p.shape)} {p.dtype} in "
                                 f"params.msgpack, the program takes {tuple(want.shape)} "
                                 f"{want.dtype}")
    return ExportedVideoService(manifest=manifest, params=params, device=device,
                                embed_program=programs[0].module().forward,
                                label_program=programs[1].module().forward)
