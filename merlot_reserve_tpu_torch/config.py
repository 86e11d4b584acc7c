"""Typed configuration with the reference's YAML surface.

The port's own copy of ``merlot_reserve_tpu/config.py``: the same frozen
dataclasses and the same ``base`` / ``large`` YAML files (shipped in this
package's ``configs/``), so a config loads identically in both packages.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def _filtered(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class ModelConfig:
    """Model tower dims; defaults follow the reference's base.yaml.

    Every field of the JAX package's ModelConfig is kept, so one YAML file
    means the same model in both packages. ``pipeline_axis`` and
    ``pipeline_microbatches`` run the joint layers as a GPipe pipeline over
    that mesh axis (``parallel/pipeline.py``).
    ``gradient_checkpoint`` and ``tower_gradient_checkpoint`` recompute the
    joint and the modality towers' layers in the backward with the
    ``gradient_checkpoint_policy`` of ``models.layers.resolve_remat_policy``;
    ``seq_shard_axis`` and ``segment_shard_axis`` are the JAX package's
    sharding hints, checked against the active mesh. ``scan_layers`` and
    ``scan_unroll`` only describe the JAX parameter layout; the port runs
    one loop over its layers either way and reads both layouts.
    """

    hidden_size: int = 768
    joint_num_layers: int = 12
    use_bfloat16: bool = True
    size_per_head: int = 64

    # audio tower
    audio_num_layers: int = 12
    audio_patch_size: int = 2
    audio_seq_length: int = 60  # mel hops per subsegment
    audio_token_length: int = 6  # pooled audio tokens per subsegment
    audio_num_mels: int = 64  # +1 playback-speed feature channel

    # vision tower
    output_grid: Tuple[int, int] = (12, 20)
    vit_patch_size: int = 16
    vit_pooling_ratio: int = 2
    vit_num_layers: int = 12

    # span tower (length excludes the CLS token the encoder adds)
    span_num_layers: int = 4
    text_span_length: int = 15

    vocab_size: int = 32768
    rotary_hsize: int = 32
    # The reference rotates pairs as [-x0, x1] rather than [-x1, x0]; the
    # released checkpoints depend on it.
    rotary_sign_quirk: bool = True
    do_rotary: bool = True
    # 'flash' = the label-masked flash forward (CUDA kernel on the card, its
    # plain version on the CPU), 'xla' = dense attention. 'auto' picks flash
    # for label-masked attention on a CUDA tensor, else dense.
    attention_impl: str = "auto"
    # Override for the joint transformer only; None = no override.
    joint_attention_impl: "str | None" = None
    gradient_checkpoint: bool = False
    gradient_checkpoint_policy: "str | None" = None
    tower_gradient_checkpoint: bool = False
    scan_layers: bool = True
    scan_unroll: int = 1
    seq_shard_axis: Optional[str] = None
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: int = 2
    segment_shard_axis: Optional[str] = None

    def __post_init__(self):
        assert self.hidden_size % self.size_per_head == 0
        assert self.audio_seq_length % self.audio_patch_size == 0
        assert self.output_grid[0] % self.vit_pooling_ratio == 0
        assert self.output_grid[1] % self.vit_pooling_ratio == 0
        audio_tokens = self.audio_seq_length // self.audio_patch_size
        assert audio_tokens % self.audio_token_length == 0

    @property
    def num_heads(self) -> int:
        return self.hidden_size // self.size_per_head

    @property
    def vit_grid_pooled(self) -> Tuple[int, int]:
        return (self.output_grid[0] // self.vit_pooling_ratio,
                self.output_grid[1] // self.vit_pooling_ratio)

    @property
    def vit_seq_len(self) -> int:
        return self.output_grid[0] * self.output_grid[1]

    @property
    def vit_pooled_seq_len(self) -> int:
        h, w = self.vit_grid_pooled
        return h * w

    @property
    def audio_pooling_ratio(self) -> int:
        # tokens-after-conv // pooled tokens, cf. modeling.py:611-612
        return (self.audio_seq_length // self.audio_patch_size) // self.audio_token_length


@dataclass(frozen=True)
class DataConfig:
    """Pretraining data shapes; defaults per base.yaml."""

    train_fns: str = ""
    num_train_files: int = 0
    use_audio_token_prob: float = 0.5

    random_scale_max: float = 1.1
    random_scale_min: float = 1.05
    # per-image random resize kernel during training (the reference picks a
    # random TF resize method per image when scale-jittering,
    # data_utils.py:8-23,110-117); False pins bilinear. Both the PIL and the
    # native fused path implement all six filters (mn_resize_patchify_k).
    random_resize_method: bool = True

    # move training-frame preprocessing (flip/resize/augment/patchify,
    # ops/vision_train.py) into the device example builder: host workers
    # only decode JPEG bytes into fixed [frame_buffer_size]^2 uint8 buffers.
    # Only consumed by DevicePretrainLoader / the fused data+train step.
    on_device_frames: bool = False
    # square frame-buffer side; must fit storage-res frames (the reference
    # corpus caps frames at shorter-288/longest-512, data/process.py) plus
    # the 8px flip markers. Oversize frames are host-downscaled and counted.
    frame_buffer_size: int = 520

    fft_hop_length: int = 588
    fft_window_size: int = 1536
    num_mels: int = 64
    sample_rate: int = 22050
    spec_size: int = 188

    mask_rate: float = 0.25

    num_audio2text_seqs: int = 1
    num_text2audio_seqs: int = 1
    num_text_seqs: int = 1
    num_text_seqs_in_record: int = 1

    num_segments: int = 16
    num_segment_groups: int = 2
    num_audio_subsegments: int = 3

    seq_len: int = 640
    lang_seq_len: int = 160

    num_text_spans_to_include: int = 48
    text_span_budget: int = 38

    @property
    def num_segments_per_group(self) -> int:
        return self.num_segments // self.num_segment_groups

    @property
    def num_audio_spans(self) -> int:
        return self.num_segments * self.num_audio_subsegments


@dataclass(frozen=True)
class DeviceConfig:
    batch_size: int = 8
    output_dir: str = ""
    iterations_per_loop: int = 7500
    commit_every_nsteps: int = 50
    n_fns_per_cycle: int = 128
    num_parallel_reads: int = 128
    shuffle_buffer_size: int = 4096
    use_tpu: bool = True
    num_tpu_cores: int = 8
    wandb_project: str = ""
    # mesh axis sizes; -1 on dp means "all remaining devices"
    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    # number of slices the dp axis spans (multi-slice pods; DCN-aware device
    # order via make_mesh(dcn_dp=...)). None/1 = single slice.
    dcn_dp: Optional[int] = None


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 4e-4
    num_train_steps: int = 750_000
    num_warmup_steps: int = 3_750
    weight_decay_rate: float = 0.1
    beta_1: float = 0.9
    beta_2: float = 0.98
    eps: float = 1e-6
    adafactor: bool = False
    use_bfloat16_adam: bool = True
    use_bfloat16_weights: bool = False
    do_bias_correction: bool = False
    final_lr_scale: float = 0.02


@dataclass(frozen=True)
class MerlotConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "MerlotConfig":
        model_raw = dict(raw.get("model", {}))
        if "output_grid" in model_raw:
            model_raw["output_grid"] = tuple(model_raw["output_grid"])
        return cls(
            model=ModelConfig(**_filtered(ModelConfig, model_raw)),
            data=DataConfig(**_filtered(DataConfig, raw.get("data", {}))),
            device=DeviceConfig(**_filtered(DeviceConfig, raw.get("device", {}))),
            optimizer=OptimizerConfig(**_filtered(OptimizerConfig, raw.get("optimizer", {}))),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "MerlotConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    def replace_model(self, **kw) -> "MerlotConfig":
        return dataclasses.replace(self, model=dataclasses.replace(self.model, **kw))

    def replace_data(self, **kw) -> "MerlotConfig":
        return dataclasses.replace(self, data=dataclasses.replace(self.data, **kw))

    def replace_device(self, **kw) -> "MerlotConfig":
        return dataclasses.replace(self, device=dataclasses.replace(self.device, **kw))

    @property
    def joint_seq_len(self) -> int:
        """lang_seq_len + vision tokens per segment group; must match data.seq_len
        when vision is present (base.yaml:37-41)."""
        return self.data.lang_seq_len + (
            self.data.num_segments_per_group * self.model.vit_pooled_seq_len)


def load_config(name_or_path: str, **model_overrides) -> MerlotConfig:
    """Load a named config ('base', 'large') or a YAML path."""
    if os.path.exists(name_or_path):
        path = name_or_path
    else:
        path = os.path.join(CONFIG_DIR, f"{name_or_path}.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no config named {name_or_path!r} at {path}")
    cfg = MerlotConfig.from_yaml(path)
    if model_overrides:
        cfg = cfg.replace_model(**model_overrides)
    return cfg
