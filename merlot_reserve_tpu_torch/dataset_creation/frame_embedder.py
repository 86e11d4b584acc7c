"""MobileNetV2 frame embedder for the dataset-creation quality filters.

The port of ``merlot_reserve_tpu/dataset_creation/frame_embedder.py``. The
reference (data/process.py:580-691) scores candidate video chunks with a
torchvision MobileNetV2 and a COCO multi-label head: the mean-pooled
``features`` are the embedding of the static-video cosine filter,
``sigmoid(classifier(...))`` the expected-object-count filter.

* ``MobileNetV2``: the inverted-residual network (width 1.0: a 32-channel
  stem, blocks [1,16,1,1] [6,24,2,2] [6,32,3,2] [6,64,4,2] [6,96,3,1]
  [6,160,3,2] [6,320,1,1], a 1280-channel head, ReLU6), inference-mode
  batch norm, as a plain ``nn.Module`` whose parameter and buffer names are
  torchvision's, so that a torchvision ``state_dict`` loads with
  ``load_state_dict``. The batch norm's eps is the JAX package's 1e-3.
* ``load_torch_mobilenet_v2``: a torchvision-format state_dict (a file or
  a dict) in the names ``MobileNetV2`` takes; a classifier stored as
  ``classifier`` or ``classifier.0`` is renamed ``classifier.1``.
* ``MobileNetV2Embedder``: the reference's preprocessing (resize (90,
  120), center crop (82, 114), ImageNet normalization, process.py:581-587)
  and the network, both on the card, in true f32 (no TF32 in the
  convolutions or the classifier: the static-video threshold of 0.85 is a
  cosine that TF32 could move across). It plugs into
  ``filters.is_static_video`` as ``frame_embedder`` and into
  ``filters.passes_object_filter`` through ``expected_object_count``.

The convolutions are ``nn.Conv2d`` (cuDNN on the card): the JAX package
computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from merlot_reserve_tpu_torch.utils.device import ieee_f32_matmul, resolve_device

# torchvision's inverted-residual schedule:
# (expand_ratio, out_channels, num_blocks, first_stride)
IR_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
# the JAX package's eps (its frame_embedder.py:40); torchvision builds
# MobileNetV2's BatchNorm2d with PyTorch's default, 1e-5
BN_EPS = 1e-3


class _ConvBN(nn.Sequential):
    """torchvision's Conv2dNormActivation: conv (``0``), batch norm (``1``),
    ReLU6 (``2``) unless ``act`` is False."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups,
                            bias=False),
                  nn.BatchNorm2d(cout, eps=BN_EPS)]
        if act:
            layers.append(nn.ReLU6())
        super().__init__(*layers)


class _InvertedResidual(nn.Module):
    """torchvision's InvertedResidual: its layers under ``conv`` (expand
    ConvBN, depthwise ConvBN, project conv, project batch norm)."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hid = cin * expand
        layers = [_ConvBN(cin, hid, kernel=1)] if expand != 1 else []
        layers += [_ConvBN(hid, hid, stride=stride, groups=hid),
                   nn.Conv2d(hid, cout, 1, bias=False), nn.BatchNorm2d(cout, eps=BN_EPS)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        return x + self.conv(x) if self.residual else self.conv(x)


class MobileNetV2(nn.Module):
    """The features trunk and an optional classifier head (COCO multi-label
    in the reference's filter checkpoint; 1000-way for stock torchvision).
    Input [N, 3, H, W] f32; output the pooled [N, 1280] features, and the
    logits when there is a head."""

    def __init__(self, num_classes: Optional[int] = None):
        super().__init__()
        layers = [_ConvBN(3, 32, stride=2)]
        cin = 32
        for expand, cout, n_blocks, stride in IR_SETTING:
            for b in range(n_blocks):
                layers.append(_InvertedResidual(cin, cout, stride if b == 0 else 1, expand))
                cin = cout
        layers.append(_ConvBN(cin, 1280, kernel=1))
        self.features = nn.Sequential(*layers)
        self.num_classes = num_classes
        if num_classes is not None:
            self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(1280, num_classes))

    def forward(self, x):
        feats = self.features(x).mean((2, 3))  # the reference's .mean([2, 3])
        if self.num_classes is None:
            return feats
        return feats, self.classifier(feats)


def load_torch_mobilenet_v2(src: Any, num_classes: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision-format state_dict (a ``torch.save`` file, or a dict of
    tensors or arrays) -> the state_dict ``MobileNetV2(num_classes)`` loads.

    Keys: ``features.0`` the stem, ``features.1``-``17`` the inverted
    residuals, ``features.18`` the head; a classifier under
    ``classifier.1`` (torchvision), ``classifier`` or ``classifier.0`` (a
    single Linear) when ``num_classes`` is given. A state_dict without
    batch norm's ``num_batches_tracked`` counters gets them (zero: they
    play no part in inference)."""
    if isinstance(src, (str, bytes)):
        sd = torch.load(src, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    else:
        sd = src
    sd = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    out = {k: v for k, v in sd.items() if k.startswith("features.")}
    if num_classes is not None:
        for cand in ("classifier.1", "classifier", "classifier.0"):
            if f"{cand}.weight" in sd:
                out["classifier.1.weight"] = sd[f"{cand}.weight"]
                out["classifier.1.bias"] = sd[f"{cand}.bias"]
                break
        else:
            raise KeyError("no classifier weights in state_dict")
    for key in MobileNetV2(num_classes).state_dict():
        if key.endswith("num_batches_tracked"):
            out.setdefault(key, torch.zeros((), dtype=torch.long))
    return out


IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _axis_weights(src: int, dst: int):
    """Half-pixel bilinear taps and weights of one axis, as the JAX package
    computes them (positions in f64, weights cast to f32)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    f = np.clip(f, 0, src - 1)
    i0 = np.floor(f).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, (f - i0).astype(np.float32)


def preprocess_frames(frames, device="cuda") -> torch.Tensor:
    """uint8 [N, H, W, 3] (an array, or a tensor on any device) ->
    normalized f32 [N, 82, 114, 3] on ``device``:
    the reference's Resize((90, 120)), CenterCrop((82, 114)) and ImageNet
    normalization (process.py:581-587), with a half-pixel bilinear resize."""
    device = resolve_device(device)
    fr = torch.as_tensor(frames).to(device).float()
    n, h, w, _ = fr.shape
    th, tw = 90, 120
    y0, y1, wy = (torch.from_numpy(a).to(device) for a in _axis_weights(h, th))
    x0, x1, wx = (torch.from_numpy(a).to(device) for a in _axis_weights(w, tw))
    wx = wx[None, None, :, None]
    wy = wy[None, :, None, None]
    top = fr[:, y0][:, :, x0] * (1 - wx) + fr[:, y0][:, :, x1] * wx
    bot = fr[:, y1][:, :, x0] * (1 - wx) + fr[:, y1][:, :, x1] * wx
    img = top * (1 - wy) + bot * wy
    oy, ox = (th - 82) // 2, (tw - 114) // 2
    img = img[:, oy:oy + 82, ox:ox + 114] / 255.0
    return (img - torch.from_numpy(IMAGENET_MEAN).to(device)) / \
        torch.from_numpy(IMAGENET_STD).to(device)


@contextlib.contextmanager
def _true_f32():
    """No TF32 in cuDNN's convolutions nor in the matrix products; both
    settings are restored on exit."""
    c = torch.backends.cudnn
    with ieee_f32_matmul(), c.flags(enabled=c.enabled, benchmark=c.benchmark,
                                    deterministic=c.deterministic, allow_tf32=False):
        yield


class MobileNetV2Embedder:
    """Callable uint8 [N, H, W, 3] -> [N, 1280] f32 embeddings (numpy), and
    the object scorer; the network and the preprocessing on ``device``.
    ``state_dict`` is ``load_torch_mobilenet_v2``'s output; without one the
    network starts from torch's initialization under ``seed``."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 num_classes: Optional[int] = None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MobileNetV2(num_classes)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, num_classes: Optional[int] = None,
                              device="cuda"):
        return cls(load_torch_mobilenet_v2(path, num_classes), num_classes, device=device)

    @torch.no_grad()
    def _forward(self, frames):
        x = preprocess_frames(frames, self.device).permute(0, 3, 1, 2).contiguous()
        with _true_f32():
            return self.model(x)

    def __call__(self, frames) -> np.ndarray:
        out = self._forward(frames)
        feats = out[0] if self.num_classes is not None else out
        return feats.cpu().numpy()

    def object_scores(self, frames) -> np.ndarray:
        """sigmoid(classifier) per frame and class: the reference's expected
        COCO objects (process.py:686-691)."""
        if self.num_classes is None:
            raise ValueError("no classifier head loaded")
        _, logits = self._forward(frames)
        return torch.sigmoid(logits).cpu().numpy()

    def expected_object_count(self, frames, prob_thresh: float = 0.3) -> float:
        """The sum of the per-class max-over-frames probabilities above
        ``prob_thresh``."""
        probs = self.object_scores(frames).max(axis=0)
        return float(probs[probs > prob_thresh].sum())
