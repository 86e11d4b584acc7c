"""Pod readiness on one card: a multi-card layout's training step run as one
stand-in rank.

The counterpart of the JAX package's ``scripts/pod_readiness.py`` and
``scripts/audit_comm.py``, which compile a layout's step for chips they do
not have. Here one process joins the layout's job as one of its ranks on
torch's fake backend (``distributed.initialize_standin``): it builds that
rank's train state through the port's own ``ShardPlan`` and
``ShardedOptimizer`` and takes full production steps, its kernels on its
device, every collective issued and recorded by ``parallel.comm`` and
answered at once. What the rank holds and computes is real, so its peak
memory (``torch.cuda.max_memory_allocated``), its collectives and its
kernel launches are a real rank's. What the rows cannot hold: NCCL's own
buffers (a fake group allocates none), any rate of NVLink or the network,
and the pipeline's bubble. Loss and gradient values are meaningless (a fake
all-gather's result is whatever its buffer held), so none is reported.

A layout's ranks that hold different things are its *roles*: rank 0
stands for every dp, tp and sp rank (rank 0 holds the first, unpadded
share of each split); under pp one rank per stage, since the stages hold
different layers. H100 nodes of 8 cards take the place of v5e slices: dp8
is one node; dp16, dcn16 and dcn16tp2 are two (``dcn_dp=2``); dp64 is
eight.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from merlot_reserve_tpu_torch.parallel import comm, distributed

NODE_CARDS = 8  # an H100 node: ranks r and s share NVLink when r // 8 == s // 8
NCCL_NOTE = "NCCL's own buffers not counted: a fake process group allocates none"
LONG_VIDEO_SEGMENTS = 80


@dataclass
class Layout:
    """One layout of the JAX package's pod readiness table, as a process mesh.

    ``mesh``: ``make_mesh`` arguments; ``global_batch``: the JAX script's
    global batch in units of the batch per chip; ``model``: config
    overrides; ``sp_impl``, ``segment_sp``: the planner's arguments for the
    layout."""

    name: str
    mesh: Dict[str, int]
    global_batch: int
    model: Dict[str, Any] = field(default_factory=dict)
    sp_impl: str = "ring:flash"
    segment_sp: int = 1
    long_video: bool = False

    @property
    def world(self) -> int:
        m = self.mesh
        return m.get("dp", 1) * m.get("sp", 1) * m.get("pp", 1) * m.get("tp", 1)

    def axis(self, name: str) -> int:
        return self.mesh.get(name, 1)

    @property
    def dcn(self) -> int:
        return self.mesh.get("dcn_dp", 1)

    @property
    def zero1_dp(self) -> int:
        """The ways ZeRO-1 shards over: the mesh's node-local dp axis."""
        return self.axis("dp") // self.dcn

    def rows(self, batch_per_chip: int) -> int:
        """Each dp rank's rows of the global batch."""
        total = int(round(self.global_batch * batch_per_chip))
        dp = self.axis("dp")
        if total % dp:
            raise ValueError(f"{self.name}: global batch {total} does not split over dp {dp}")
        return total // dp

    def roles(self) -> List[int]:
        """The ranks that stand for the layout: rank 0, and under pp the
        first rank of every other stage (tp innermost, pp next)."""
        tp, pp = self.axis("tp"), self.axis("pp")
        return [stage * tp for stage in range(pp)]


_SP = dict(seq_shard_axis="sp", joint_attention_impl="ring:flash")

LAYOUTS: Dict[str, Layout] = {
    "dp8": Layout("dp8 (1 node of 8 H100)", dict(dp=8), 8),
    "dp4xsp2": Layout("dp4xsp2 ring:flash (1 node of 8 H100)", dict(dp=4, sp=2), 8, _SP),
    "dp4xsp2ulysses": Layout("dp4xsp2 ulysses:flash (1 node of 8 H100)", dict(dp=4, sp=2), 8,
                             dict(_SP, joint_attention_impl="ulysses:flash"),
                             sp_impl="ulysses:flash"),
    "longvideo": Layout("longvideo80 dp2xsp2 ring:flash (4 H100)", dict(dp=2, sp=2), 2,
                        dict(_SP, gradient_checkpoint=True, tower_gradient_checkpoint=True,
                             segment_shard_axis="sp"), segment_sp=2, long_video=True),
    "dp4xtp2": Layout("dp4xtp2 (1 node of 8 H100)", dict(dp=4, tp=2), 4),
    "dp2pp2tp2": Layout("dp2xpp2xtp2 (1 node of 8 H100)", dict(dp=2, pp=2, tp=2), 4,
                        dict(scan_layers=True, pipeline_axis="pp", pipeline_microbatches=2)),
    "dp16": Layout("dp16 (2 nodes of 8 H100)", dict(dp=16), 16),
    "dcn16": Layout("dp16 dcn_dp=2 (2 nodes of 8 H100)", dict(dp=16, dcn_dp=2), 16),
    "dcn16tp2": Layout("dp8xtp2 dcn_dp=2 (2 nodes of 8 H100)", dict(dp=8, tp=2, dcn_dp=2), 8),
    "dp64": Layout("dp64 (8 nodes of 8 H100)", dict(dp=64), 64),
}
# the per-chip batch of a layout whose batch is fixed (the long video: one
# video per dp rank, as the JAX script's)
_FIXED_BATCH = {"longvideo": 1}


def layout_config(cfg, layout: Layout):
    """``cfg`` with the layout's model overrides, and for the long video
    80 segments (joint seq_len scaled as the JAX script scales it)."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **layout.model))
    if layout.long_video:
        d, m = cfg.data, cfg.model
        per_seg = (m.output_grid[0] * m.output_grid[1]) // (m.vit_pooling_ratio ** 2)
        cfg = cfg.replace_data(
            num_segments=LONG_VIDEO_SEGMENTS,
            seq_len=d.lang_seq_len + (LONG_VIDEO_SEGMENTS // d.num_segment_groups) * per_seg)
    return cfg


def layout_rows(name: str, batch_per_chip: int) -> int:
    """Each dp rank's rows of ``name``'s batch at ``batch_per_chip``."""
    return LAYOUTS[name].rows(_FIXED_BATCH.get(name, batch_per_chip))


def plan(cfg, layout: Layout, rows: int) -> Dict[str, float]:
    """``memory.estimate_train_hbm`` of one rank of ``layout``."""
    from merlot_reserve_tpu_torch.parallel import memory

    sp = layout.axis("sp")
    return memory.estimate_train_hbm(
        cfg, rows, zero1_dp=layout.zero1_dp, pp=layout.axis("pp"), tp=layout.axis("tp"),
        sp=sp, dcn=layout.dcn, sp_impl=layout.sp_impl if sp > 1 else "ring:flash",
        segment_sp=layout.segment_sp)


def _top(records: List[Dict[str, Any]], n: int = 8) -> List[Dict[str, Any]]:
    top = sorted(records, key=lambda r: -r["bytes"])[:n]
    return [{"op": r["op"], "mib": r["bytes"] / 2 ** 20, "axis": r["axis"], "what": r["what"],
             "dtype": r["dtype"]} for r in top]


def run_role(cfg, layout: Layout, rank: int, rows: int, steps: int = 2, device="cuda",
             seed: int = 0, keep_records: bool = False, zero1: bool = True) -> Dict[str, Any]:
    """Rank ``rank`` of ``layout`` as a stand-in on ``device``: its train
    state from a seeded full model (``create_distributed_train_state``),
    then ``steps`` training steps on ``rows`` dummy examples.

    Returns its bytes of state, its peak (``max_memory_allocated`` over the
    steps, less what the device held before the role started: the state is
    counted, the full model it was cut from is not), per step the kernel
    launches and the comm summary, and the last step's split by node and
    top collectives (``keep_records``: every step's records). ``zero1``
    False keeps every master and moment whole on the rank."""
    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (
        MerlotReservePretrainer,
        batch_to_tensors,
    )
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.training.trainer import (
        create_distributed_train_state,
        train_step,
    )

    cuda = torch.device(device).type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() if cuda else 0
    dev = distributed.initialize_standin(layout.world, rank, device, NODE_CARDS)
    try:
        mesh = make_mesh(**layout.mesh)
        t0 = time.perf_counter()
        state = create_distributed_train_state(
            cfg, MerlotReservePretrainer(cfg, device=dev, seed=seed), mesh, zero1=zero1)
        build_s = time.perf_counter() - t0
        batch = batch_to_tensors(make_dummy_batch(cfg, rows, seed=seed), dev)
        if cfg.model.use_bfloat16:  # as the loop's DeviceFeed hands them over
            for k in ("images", "audio_clips"):
                batch[k] = batch[k].to(torch.bfloat16)
        nbytes = state.optimizer.held_bytes()
        if cuda:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        resident = (torch.cuda.memory_allocated() - held) if cuda else None
        launches, summaries, all_records, step_s = [], [], [], []
        for _ in range(steps):
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            with activate_mesh(mesh), comm.recording() as records:
                train_step(state, batch)
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            launches.append(dict(kernels.LAUNCHES))
            summaries.append(comm.summarize_records(records))
            all_records.append(list(records))
        peak = (torch.cuda.max_memory_allocated() - held) if cuda else None
        coords = dict(zip(mesh.axis_names, mesh.coords))
    finally:
        state = batch = None
        distributed.shutdown()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    last = all_records[-1]
    out = {"rank": rank, "world": layout.world, "coords": coords, "rows": rows,
           "peak_bytes": peak, "resident_bytes": resident, "state_bytes": nbytes,
           "launches_per_step": launches, "comm_per_step": summaries,
           "intra_inter_split": comm.split_intra_inter(last, NODE_CARDS),
           "top_collectives": _top(last), "build_s": build_s, "step_s": step_s,
           "standin": True}
    if keep_records:
        out["records"] = all_records
    return out


def run_layout(cfg, name: str, batch_per_chip: int, steps: int = 2, device="cuda",
               seed: int = 0) -> Dict[str, Any]:
    """Every role of layout ``name`` in turn (the group torn down between
    them), and the layout's row: the largest peak of its roles beside the
    planner's total. A role that runs out of device memory is a result
    ("OOM" and the allocator's message), not a failure."""
    layout = LAYOUTS[name]
    cfg = layout_config(cfg, layout)
    rows = layout_rows(name, batch_per_chip)
    roles, oom = [], None
    for rank in layout.roles():
        try:
            roles.append(run_role(cfg, layout, rank, rows, steps, device, seed))
        except torch.cuda.OutOfMemoryError as e:
            oom = f"OOM at rank {rank}: {str(e).splitlines()[0][:300]}"
            break
    est = plan(cfg, layout, rows)
    row = {"layout": layout.name, "key": name, "standin": True, "world": layout.world,
           "mesh": layout.mesh, "run": oom or "clean",
           "config_seq_len": cfg.data.seq_len, "segments": cfg.data.num_segments,
           "scan_layers": cfg.model.scan_layers, "remat": cfg.model.gradient_checkpoint,
           "tower_remat": cfg.model.tower_gradient_checkpoint,
           "joint_attention_impl": cfg.model.joint_attention_impl,
           "per_chip_batch": rows * layout.axis("dp") / layout.world,
           "global_batch": rows * layout.axis("dp"), "batch": rows,
           "zero1_dp": layout.zero1_dp, "sp": layout.axis("sp"), "tp": layout.axis("tp"),
           "pp": layout.axis("pp"), "dcn": layout.dcn, "sp_impl": layout.sp_impl,
           "segment_sp": layout.segment_sp,
           "planner_total_gib": est["total"] / 2 ** 30, "nccl_buffers": NCCL_NOTE,
           "roles": roles}
    peaks = [r["peak_bytes"] for r in roles if r["peak_bytes"] is not None]
    if peaks and oom is None:
        worst = max(roles, key=lambda r: r["peak_bytes"])
        row["hbm_highwater_gib"] = worst["peak_bytes"] / 2 ** 30
        row["highwater_rank"] = worst["rank"]
        row["planner_error"] = (est["total"] - worst["peak_bytes"]) / worst["peak_bytes"]
    if roles:
        first = roles[0]["comm_per_step"][-1]
        row["collectives"] = {k: v for k, v in first.items()
                              if k not in ("total_bytes", "total_count")}
        row["collective_total_mib_per_step"] = first["total_bytes"] / 2 ** 20
        row["collective_count"] = first["total_count"]
        row["intra_inter_split"] = roles[0]["intra_inter_split"]
        row["top_collectives"] = roles[0]["top_collectives"]
        row["launches_per_step"] = {r["rank"]: r["launches_per_step"][-1] for r in roles}
    return row
