"""The memory planner: a training step's peak device memory per card,
before a run.

The counterpart of ``merlot_reserve_tpu/parallel/memory.py``, rebuilt for
the 80 GB H100. It keeps the JAX package's terms (the train state, the
step's transients, the activations saved for the backward by tower and
layer, the dense attention probabilities, the pipeline's stream) and how
each divides under ZeRO-1, tp, pp and sp; its coefficients are fit on the
port's own peaks (``torch.cuda.max_memory_allocated``, ``chip_smoke.py``,
NVIDIA H100 80GB HBM3 at 700 W, PERF.md), not on any TPU number:

    base step, batch 8, flash joint, no remat              35.99 GiB (PR 8)
    fixres mixed step, 4 + 4 at seq_len 1312, no remat     75.71 GiB (PR 10)
    long-video step, batch 4, both remat knobs             10.85 GiB (PR 7)
    long-video step, batch 1, above resident, remat off    19.1 GiB  (PR 7)
    long-video step, batch 1, above resident, remat on     3.0 GiB   (PR 7)

``scripts/plan_memory_torch.py`` prints the plan of a config and layout and
this table against the fit.

The port's step, one card: the f32 masters and the bf16 moments (8 bytes a
parameter, resident); at the step's peak the f32 gradients (4 bytes a
parameter, fit); per transformer layer a number of [rows, seq, hidden]
bf16 tensors kept for the backward (``_ACT_TENSORS``; under remat the layer
boundaries and one layer's recompute, ``_REMAT_TENSORS``), and the dense
path's attention probabilities (the modality towers attend densely: they
carry no labels). Five points fix four coefficients, so the fit checks
itself once.

A rank of a layout across processes (ZeRO-1, tp, pp, sp) runs the
``ShardedOptimizer``'s step, whose terms differ from one card's. Resident:
the model's bf16 compute copies of the rank's tp and pp share (2 bytes a
local parameter) and its ZeRO-1 share of the f32 masters and moments. The
step peaks in one of two phases. In the backward: the activations, of
which a share of each layer's saved tensors (the qkv heads, the attention
context, the MLP's hidden; not the layer boundaries that remat keeps)
splits over tp (``_TP_SPLIT_SHARE``), a pipeline stage keeps its share of
the joint layers, and a joint layer split over sp keeps 1/sp of its
tensors and the ring's or Ulysses' own (``_SP_TENSORS``). In the update
(``ShardedOptimizer._reduce`` and the compute copies' rebuild): the bf16
gradients with the ZeRO-1 entries' moved and flat copies
(``_UPDATE_ZERO_BYTES``) and their f32 shard (``_UPDATE_SHARD_BYTES``, of
the 1/dp share), and the other entries' flat copy and its f32 casts
(``_UPDATE_WHOLE_BYTES``). The phase terms are fit on stand-in ranks'
peaks on the card (``scripts/pod_readiness_torch.py`` ->
``docs/pod_readiness_results_torch.jsonl``; ``scripts/
fit_memory_model_torch.py`` refits them), which count no NCCL buffers: a
fake process group allocates none. Two terms of the JAX planner fit 0 on
those rows and are left out: the bf16 gradients beside the backward's
activations (the backward peaks at its start, before they accumulate)
and a pipeline stage's stream of microbatches (lost in the rest).
"""

from __future__ import annotations

from typing import Dict, Optional

GIB = 2 ** 30
H100_HBM_BYTES = 80 * GIB

# fit by least squares on the port's five measured peaks (module
# docstring), four coefficients, rounded; every point within 2.1%
# (fit_errors())
_ACT_TENSORS = 23.4     # bf16 [rows, seq, hidden] tensors a layer keeps, no remat
_REMAT_TENSORS = 2.5    # under remat: the layer boundaries and one layer's recompute
_PROBS_TENSORS = 1.0    # dense attention: [rows, heads, seq, seq] bf16 probabilities
_TRANSIENT_BYTES = 4    # per parameter at the step's peak: the f32 gradient
_STATE_BYTES = 8        # per parameter: f32 master, bf16 mu, bf16 nu

# a rank of a process mesh (module docstring): fit by
# scripts/fit_memory_model_torch.py on the 38 stand-in rows, every row within
# 11.2%
_COMPUTE_COPY_BYTES = 2     # per local parameter: the model's bf16 compute copy, resident
_UPDATE_ZERO_BYTES = 5.35   # update: per ZeRO-1 parameter, gradient, moved and flat copies
_UPDATE_SHARD_BYTES = 8.6   # update: per parameter of the ZeRO-1 share, its f32 casts
_UPDATE_WHOLE_BYTES = 14.8  # update: per other local parameter, gradient, flat, f32 casts
_TP_SPLIT_SHARE = 0.65      # share of a layer's saved tensors (no remat) that split over tp
# per joint layer, each family a stand-in row measures; Ulysses on the dense
# inner attention ("ulysses") has no row yet and raises
_SP_TENSORS = {"ring:flash": 0.55, "ulysses:flash": 0.35}

# the measured peaks the coefficients are fit on (GiB; see the docstring)
MEASURED_PEAKS = {
    "base_b8": 35.99,
    "fixres_b8": 75.71,
    "longvideo_b4_remat": 10.85,
    "longvideo_b1_above_resident": 19.1,
    "longvideo_b1_above_resident_remat": 3.0,
}


def _layer_params(h: int) -> int:
    """One pre-LN transformer layer: qkv (3h^2 + 3h), attn_proj (h^2), the
    two LayerNorms (4h), the MLP (4h^2 + 4h, 4h^2)."""
    return 12 * h * h + 11 * h


def _encoder_params(h: int, layers: int, cls_out: Optional[int] = None,
                    pe_len: Optional[int] = None) -> int:
    n = layers * _layer_params(h) + 4 * h  # + pre_ln, final_ln
    if cls_out is not None:
        n += h + h * cls_out + cls_out  # the CLS token and its projection
    if pe_len is not None:
        n += pe_len * h
    return n


def param_count(cfg) -> int:
    """The pretrainer's parameter count (the port's model and the JAX
    package's tree hold the same leaves): token embedding, the vision,
    audio and span towers, the joint transformer, the head and the three
    temperatures."""
    m = cfg.model
    h = m.hidden_size
    gh, gw = m.output_grid
    rotary = m.do_rotary
    pool = 4 * (h * h + h)  # the attention pool's query, key, value, out
    vision = (m.vit_patch_size ** 2 * 3 * h + h
              + _encoder_params(h, m.vit_num_layers, h, None if rotary else gh * gw + 1) + pool)
    audio_len = m.audio_seq_length // m.audio_patch_size
    audio = (m.audio_patch_size * (m.audio_num_mels + 1) * h + h
             + _encoder_params(h, m.audio_num_layers, h, None if rotary else audio_len + 1) + pool)
    span = _encoder_params(h, m.span_num_layers, h, None if rotary else m.text_span_length + 1)
    joint = _encoder_params(h, m.joint_num_layers, None,
                            None if rotary else cfg.data.seq_len)
    return int(m.vocab_size * h + vision + audio + span + joint + h * h + h + 3)


def _tower_rows(cfg, batch: int) -> Dict[str, tuple]:
    """(rows, seq, layers, dense) of each transformer on a batch."""
    m, d = cfg.model, cfg.data
    gh, gw = m.output_grid
    joint_rows = batch * (d.num_segment_groups * (d.num_audio2text_seqs + d.num_text2audio_seqs)
                          + 1 + d.num_text_seqs)
    return {
        "vision": (batch * d.num_segments, gh * gw + 1, m.vit_num_layers, True),
        "audio": (batch * d.num_segments * d.num_audio_subsegments,
                  m.audio_seq_length // m.audio_patch_size + 1, m.audio_num_layers, True),
        "span": (batch * d.num_text_spans_to_include, m.text_span_length + 1,
                 m.span_num_layers, False),
        "joint": (joint_rows, d.seq_len, m.joint_num_layers, False),
    }


def estimate_train_hbm(cfg, batch_size: int, remat: Optional[bool] = None,
                       zero1_dp: int = 1, pp: int = 1, flash: bool = True, tp: int = 1,
                       sp: int = 1, tower_remat: Optional[bool] = None, dcn: int = 1,
                       sp_impl: str = "ring:flash", segment_sp: int = 1) -> Dict[str, float]:
    """Peak device bytes of one pretraining step on one card.

    With every layout argument 1 the one-card step (``train_step`` without
    a mesh); else a rank of a process mesh (``ShardedOptimizer``, module
    docstring).

    :param batch_size: the card's rows of the batch (the global batch over dp)
    :param remat: the joint tower's ``gradient_checkpoint`` (default the config's)
    :param zero1_dp: ways the f32 masters and moments shard over (ZeRO-1:
        the mesh's node-local dp axis; only the entries without a tp or pp
        share divide)
    :param pp: pipeline stages: the joint layers' parameters and saved
        activations divide, plus the stage's stream of microbatches
    :param flash: the joint tower on the flash kernels (else its dense
        probabilities are saved too)
    :param tp: Megatron ways: every transformer layer's four kernels and the
        vocabulary divide, and the share of each layer's saved tensors that
        is split by heads or by the MLP's hidden width
    :param sp: ranks of a sequence split across processes: the joint layers'
        saved activations divide
    :param tower_remat: the modality towers' ``tower_gradient_checkpoint``
        (default the config's)
    :param dcn: nodes the dp axis spans (``make_mesh(dcn_dp=...)``); moves
        no byte. The port's ZeRO-1 shards over the node-local dp only, so
        pass ``zero1_dp`` = dp / dcn; the shard's sum over the nodes is one
        all-reduce in place (``ShardedOptimizer._reduce``)
    :param sp_impl: the joint attention's sequence split: 'ring:flash' (the
        default) or 'ulysses:flash'; each keeps its own tensors per joint
        layer (``_SP_TENSORS``). 'ulysses' (dense inner attention) raises
        until a stand-in row measures it; the JAX package's 'gspmd' has no
        counterpart here and raises
    :param segment_sp: ways ``segment_shard_axis`` splits the towers' rows;
        moves no byte. On a process mesh every sp rank encodes all of its
        dp rows (``parallel.mesh.rows_anchor`` returns its inputs there), so
        the towers' terms do not divide; it must divide the rows
    :return: {'params', 'state_bytes', 'step_transient_bytes',
        'activation_bytes', 'resident_bytes', 'total'} in bytes, and the
        rank's 'local_params' and 'zero1_params' (those ZeRO-1 splits)
    """
    if sp_impl not in _SP_TENSORS:
        raise ValueError(f"sp_impl {sp_impl!r}: the planner models {sorted(_SP_TENSORS)}, the "
                         "families a stand-in row measures (the port has no GSPMD)")
    m = cfg.model
    h = m.hidden_size
    remat = m.gradient_checkpoint if remat is None else remat
    tower_remat = m.tower_gradient_checkpoint if tower_remat is None else tower_remat
    pp, tp, sp, zero1_dp = max(pp, 1), max(tp, 1), max(sp, 1), max(zero1_dp, 1)
    segment_sp = max(segment_sp, 1)
    rows = _tower_rows(cfg, batch_size)
    if (batch_size * cfg.data.num_segments) % segment_sp:
        raise ValueError(f"segment_sp={segment_sp} does not divide {batch_size} x "
                         f"{cfg.data.num_segments} segments")
    on_mesh = max(zero1_dp, pp, tp, sp) > 1
    total_params = param_count(cfg)
    matmuls = 12 * h * h
    n_other = m.vit_num_layers + m.audio_num_layers + m.span_num_layers
    joint_layers = m.joint_num_layers * _layer_params(h)
    # entries with a tp or pp share (never also ZeRO-1), and the rest
    sharded = 0.0
    rest = float(total_params)
    if pp > 1:
        sharded += (joint_layers - m.joint_num_layers * matmuls * (1 - 1 / tp)) / pp
        rest -= joint_layers
    elif tp > 1:
        sharded += m.joint_num_layers * matmuls / tp
        rest -= m.joint_num_layers * matmuls
    if tp > 1:
        sharded += (n_other * matmuls + m.vocab_size * h) / tp
        rest -= n_other * matmuls + m.vocab_size * h
    local = sharded + rest
    state = _STATE_BYTES * (sharded + rest / zero1_dp)
    resident = state + (_COMPUTE_COPY_BYTES * local if on_mesh else 0.0)

    act = 0.0
    heads = h // m.size_per_head
    tp_div = 1 - _TP_SPLIT_SHARE + _TP_SPLIT_SHARE / tp
    for name, (n_rows, seq, layers, dense) in rows.items():
        joint = name == "joint"
        if joint:
            layers = layers / pp
        on = remat if joint else tower_remat
        per_layer = (_REMAT_TENSORS if on else _ACT_TENSORS * tp_div) * n_rows * seq * h * 2
        if not on and (dense or (joint and not flash and sp == 1)):
            per_layer += _PROBS_TENSORS * n_rows * (heads / tp) * seq * seq * 2
        if joint and sp > 1:
            per_layer = per_layer / sp + _SP_TENSORS[sp_impl] * n_rows * seq / sp * h * 2
        act += per_layer * layers
    zero = rest if zero1_dp > 1 else 0.0  # the entries ZeRO-1 splits
    if on_mesh:
        update = (_UPDATE_ZERO_BYTES * zero + _UPDATE_SHARD_BYTES * zero / zero1_dp
                  + _UPDATE_WHOLE_BYTES * (local - zero))
        transients = update if update > act else 0.0
        total = resident + max(act, update)
    else:
        transients = _TRANSIENT_BYTES * local
        total = resident + transients + act
    out = {"params": float(total_params), "state_bytes": float(state),
           "step_transient_bytes": float(transients), "activation_bytes": float(act),
           "resident_bytes": float(resident), "total": float(total),
           "local_params": float(local), "zero1_params": float(zero)}
    return out


def fits_h100(cfg, batch_size: int, hbm_bytes: float = H100_HBM_BYTES, **layout) -> bool:
    """Whether ``estimate_train_hbm`` fits in ``hbm_bytes`` (default 80 GiB)."""
    return estimate_train_hbm(cfg, batch_size, **layout)["total"] <= hbm_bytes


def calibration_points():
    """(name, predicted GiB, measured GiB) for every peak the coefficients
    are fit on, from the configs the measured runs used."""
    import dataclasses

    from merlot_reserve_tpu_torch.config import load_config

    base = load_config("base")
    fixres = [load_config("base", output_grid=g) for g in ((18, 32), (24, 24))]
    fixres = [c.replace_data(seq_len=c.joint_seq_len) for c in fixres]  # 1312 at both
    long = load_config("soak_longvideo")
    long_off = dataclasses.replace(long, model=dataclasses.replace(
        long.model, gradient_checkpoint=False, tower_gradient_checkpoint=False))

    def above(c, b):
        e = estimate_train_hbm(c, b)
        return e["total"] - e["resident_bytes"]

    # the mixed step: one state, both halves' activations (4 examples each)
    mixed = estimate_train_hbm(fixres[0], 4)
    mixed_total = mixed["total"] + estimate_train_hbm(fixres[1], 4)["activation_bytes"]
    pred = {"base_b8": estimate_train_hbm(base, 8)["total"],
            "fixres_b8": mixed_total,
            "longvideo_b4_remat": estimate_train_hbm(long, 4)["total"],
            "longvideo_b1_above_resident": above(long_off, 1),
            "longvideo_b1_above_resident_remat": above(long, 1)}
    return [(k, pred[k] / GIB, MEASURED_PEAKS[k]) for k in MEASURED_PEAKS]


def fit_errors() -> Dict[str, float]:
    """Relative error of the plan against each measured peak."""
    return {name: (p - m) / m for name, p, m in calibration_points()}
