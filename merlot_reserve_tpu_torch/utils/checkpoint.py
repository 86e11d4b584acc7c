"""Checkpoints in the flax-msgpack format, and layer-layout converters.

The port of ``merlot_reserve_tpu/utils/checkpoint.py``'s msgpack half. A
checkpoint is one file ``<path>/ckpt_<step>``: the msgpack
(``utils.msgpack``) of the tree a flax ``TrainState`` serializes to,
``{"step", "params", "opt_state"}``, with every f32 leaf stored as f16 and
the Adam moments as bf16, as the JAX package and the released
``gs://merlotreserve`` checkpoints store them. So either package reads the
other's files. ``state_to_flax`` / ``load_state_from_flax`` map a port
``TrainState`` to and from that tree, with ``opt_state`` in the optax
chain's layout (see ``state_to_flax``).

The JAX package's writer produces this format only with flax's
``flax_use_orbax_checkpointing`` set to False: under newer flax its
default writes an orbax directory instead, which ``load_checkpoint``
refuses with a message naming that flag.

A train state sharded across processes (``training.optimization.
ShardedOptimizer``) can be saved in the same one-file format: every process
takes part in gathering its shards (``state_to_flax``), and only rank 0
writes the file. At a resume every process reads the file and keeps its
share, so a checkpoint of any layout resumes in any other, the one-process
one included.

The sharded half, the counterpart of the JAX module's orbax half
(``orbax_manager``, ``save_checkpoint_orbax``, ``load_checkpoint_orbax``):
``sharded_manager``, ``save_checkpoint_sharded`` and
``load_checkpoint_sharded`` write per-rank shards with
``torch.distributed.checkpoint`` into a directory ``<path>/<step>/``. Each
rank writes only the shares it holds (its ZeRO-1 shards of the masters and
moments, its tp shares, its pp stage's entries), each share once across the
job and under a key of its own (``params/<flax path>#dp<i>``,
``mu/<entry>#tp<j>``, ``nu/<entry>``), so nothing is gathered to rank 0;
``layout.json`` records the split. Each share is stored in the state's
own dtype (f32 masters, f32 or bf16 moments, the bf16 anchor), as orbax
stores the JAX train state, so a resume gives back the saved state bit for
bit; only the msgpack file, the released checkpoints' format, rounds f32
to f16. A checkpoint appears whole or not at all:
the ranks write into ``<step>.tmp/`` and rank 0 renames it after a barrier.
At the layout it was written at each rank reads back only its own shares;
at another (dp 2 to one process, one process to dp 2, dp 2 to tp 2) every
rank reads all of them and keeps its share. The format is the port's own:
orbax's cannot be read without JAX.

The layer-layout converters: the reference checkpoints store one
``layer_NN`` subtree per transformer layer; the JAX package's
scan-over-layers models store one ``layers`` subtree whose leaves are
stacked along a leading [num_layers] axis.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.parallel import distributed
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.weights import (
    flax_tensors_from_state_dict,
    from_flax_layout,
    state_dict_from_flax,
)

PREFIX = "ckpt_"
_STEP_RE = re.compile(r"^ckpt_(\d+)$")
_LAYER_RE = re.compile(r"^layer_(\d+)$")
_ORBAX_FILES = ("manifest.ocdbt", "_METADATA", "_CHECKPOINT_METADATA", "checkpoint")


# ---------------------------------------------------------------------------
# dtype maps over trees
# ---------------------------------------------------------------------------


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cast(from_dtype, to_dtype, tree):
    return _map_leaves(lambda x: x.to(to_dtype) if isinstance(x, torch.Tensor)
                       and x.dtype == from_dtype else x, tree)


def compress_state(tree):
    """f32 leaves -> f16 (more mantissa than bf16), as checkpoints store them."""
    return _cast(torch.float32, torch.float16, tree)


def decompress_state(tree):
    return _cast(torch.float16, torch.float32, tree)


def bf16_to_f32(tree):
    return _cast(torch.bfloat16, torch.float32, tree)


def f32_to_bf16(tree):
    return _cast(torch.float32, torch.bfloat16, tree)


# ---------------------------------------------------------------------------
# the train state as a flax tree
# ---------------------------------------------------------------------------


def _flax_tree(model, named: Dict[str, torch.Tensor]) -> Dict:
    tree = flax_tensors_from_state_dict(named, model.config.size_per_head)
    return tree if model.config.scan_layers else unstack_layer_params(tree)


def state_to_flax(state) -> Dict:
    """The tree a JAX ``TrainState`` of the same model and chain serializes
    to, its leaves tensors on the state's device (views of the parameters
    where the map is a transpose or reshape: copy before the next update):

        {"step": int32,
         "params": the flax parameter tree (f32),
         "opt_state": {"0": {"count": int32, "mu": tree, "nu": tree},
                                 (bf16, or f32 with use_bfloat16_adam off: optax's
                                  ScaleByAdamState(count, mu, nu))
                       "1": {"inner_state": {}}                  (pretraining:
                                                 add_decayed_weights' MaskedState)
                          or {"orig_params": tree (bf16)}        (finetuning:
                                                 subtract_old_weights' anchor),
                       "2": {"count": int32},                    (scale_by_schedule)
                       "3": {}}}                                 (scale)

    mu, nu and the anchor take the parameters' name map and kernel
    reshapes. With ``scan_layers`` off the per-layer leaves are in the
    ``layer_NN`` layout, as the JAX model's tree is. A state sharded across
    processes gives the whole state's tree on every process (each one must
    call this: the shards are gathered)."""
    model, opt = state.model, state.optimizer
    if hasattr(opt, "full_state"):
        whole = opt.full_state()
        params, mu, nu, anchor = whole["params"], whole["mu"], whole["nu"], whole["anchor"]
    else:
        params, mu, nu, anchor = dict(model.named_parameters()), opt.mu, opt.nu, opt.anchor
    count = torch.tensor(opt.count, dtype=torch.int32)
    second = ({"inner_state": {}} if anchor is None
              else {"orig_params": _flax_tree(model, anchor)})
    return {"step": torch.tensor(state.step, dtype=torch.int32),
            "params": _flax_tree(model, params),
            "opt_state": {"0": {"count": count, "mu": _flax_tree(model, mu),
                                "nu": _flax_tree(model, nu)},
                          "1": second, "2": {"count": count.clone()}, "3": {}}}


def _check_moments(adam, moments: Dict[str, torch.Tensor]) -> None:
    """Refuse a file whose Adam moments are not the state's kind: bf16 (the
    bf16 Adam) or f32 (``use_bfloat16_adam`` off; f16 in the file)."""
    have = next(_leaves(adam["mu"])).dtype == torch.bfloat16
    want = next(iter(moments.values())).dtype == torch.bfloat16
    if have != want:
        kinds = {True: "bf16 Adam", False: "f32 Adam"}
        raise ValueError(f"the checkpoint's moments are {kinds[have]}'s, the state's "
                         f"{kinds[want]}'s (use_bfloat16_adam)")


def _load_named(target: Dict[str, torch.Tensor], tree, what: str) -> None:
    sd = state_dict_from_flax(tree, dtype=None)
    missing = sorted(set(target) - set(sd))
    unused = sorted(set(sd) - set(target))
    shapes = sorted(k for k in set(sd) & set(target) if sd[k].shape != target[k].shape)
    if missing or unused or shapes:
        raise ValueError(f"checkpoint {what} do not fit: missing {missing}, unused {unused}, "
                         f"wrong shape {shapes}")
    with torch.no_grad():
        for k, t in target.items():
            t.copy_(sd[k])


def load_state_from_flax(state, tree: Dict):
    """Copy a ``state_to_flax``-shaped tree (f32 or f16 parameters, either
    layer layout) into ``state`` in place; returns it. Without an
    ``opt_state`` (a ``no_optimizer`` checkpoint) only the parameters and
    the step are read. A state sharded across processes keeps its share."""
    model, opt = state.model, state.optimizer
    if hasattr(opt, "load_full_state"):
        return _load_sharded(state, tree)
    _load_named(dict(model.named_parameters()), tree["params"], "params")
    state.step = int(tree["step"])
    opt_state = tree.get("opt_state")
    if opt_state is not None:
        adam = opt_state["0"]
        _check_moments(adam, opt.mu)
        _load_named(opt.mu, adam["mu"], "mu")
        _load_named(opt.nu, adam["nu"], "nu")
        opt.count = int(adam["count"])
        has_anchor = "orig_params" in opt_state["1"]
        if has_anchor != (opt.anchor is not None):
            raise ValueError("the checkpoint's optimizer chain is not the state's: "
                             f"{'finetuning' if has_anchor else 'pretraining'} in the file")
        if has_anchor:
            _load_named(opt.anchor, opt_state["1"]["orig_params"], "orig_params")
    return state


def _whole_named(shapes: Dict[str, torch.Size], tree, what: str) -> Dict[str, torch.Tensor]:
    sd = state_dict_from_flax(tree, dtype=None)
    missing = sorted(set(shapes) - set(sd))
    unused = sorted(set(sd) - set(shapes))
    wrong = sorted(k for k in set(sd) & set(shapes) if sd[k].shape != shapes[k])
    if missing or unused or wrong:
        raise ValueError(f"checkpoint {what} do not fit: missing {missing}, unused {unused}, "
                         f"wrong shape {wrong}")
    return sd


def _load_sharded(state, tree: Dict):
    """``load_state_from_flax`` for a ``ShardedOptimizer``'s state: every
    process reads the whole tree and keeps its share."""
    opt = state.optimizer
    shapes = opt.plan.full_shapes
    params = _whole_named(shapes, tree["params"], "params")
    state.step = int(tree["step"])
    kw = {}
    opt_state = tree.get("opt_state")
    if opt_state is not None:
        adam = opt_state["0"]
        _check_moments(adam, opt.inner.mu)
        kw = dict(mu=_whole_named(shapes, adam["mu"], "mu"),
                  nu=_whole_named(shapes, adam["nu"], "nu"), count=int(adam["count"]))
        has_anchor = "orig_params" in opt_state["1"]
        if has_anchor != (opt.inner.anchor is not None):
            raise ValueError("the checkpoint's optimizer chain is not the state's: "
                             f"{'finetuning' if has_anchor else 'pretraining'} in the file")
        if has_anchor:
            kw["anchor"] = _whole_named(shapes, opt_state["1"]["orig_params"], "orig_params")
    params = {k: v.float() for k, v in params.items()}
    opt.load_full_state(params, **kw)
    return state


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def _checkpoints(path: str) -> List[tuple]:
    """(step, file) of every ``ckpt_<step>`` in ``path``, oldest first."""
    if not os.path.isdir(path):
        return []
    found = [(int(m.group(1)), os.path.join(path, name))
             for name in os.listdir(path) if (m := _STEP_RE.match(name))]
    return sorted(found)


def save_checkpoint(state, path: str, keep: Optional[int] = None, overwrite: bool = True,
                    no_optimizer: bool = False) -> str:
    """Write ``state`` (a port ``TrainState``, or a flax-shaped tree with a
    ``step``) to ``path/ckpt_<step>`` with f32 leaves compressed to f16, as
    flax's msgpack writer does: to ``path/ckpt_tmp`` first, then renamed.
    Keeps the newest ``keep`` checkpoints (default all); with ``overwrite``
    a checkpoint of a later step is removed, without it one of the same or
    a later step raises. Returns the file's path. A stand-in rank
    (``parallel.distributed.initialize_standin``) is refused."""
    distributed.refuse_standin("save_checkpoint")
    tree = state if isinstance(state, dict) else state_to_flax(state)
    if no_optimizer:
        tree = dict(tree, opt_state=None)
    return _write(compress_state(tree), path, keep, overwrite)


def _write(tree: Dict, path: str, keep: Optional[int], overwrite: bool) -> str:
    """Write ``tree`` as ``path/ckpt_<step>``; in a job of several processes
    only rank 0 writes (the others return the path it writes)."""
    step = int(tree.get("step", 0) or 0)
    if distributed.process_index() != 0:
        return os.path.join(path, f"{PREFIX}{step}")
    existing = _checkpoints(path)
    if not overwrite and existing and existing[-1][0] >= step:
        raise FileExistsError(f"{path} holds a checkpoint at step {existing[-1][0]} >= {step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PREFIX + "tmp")
    target = os.path.join(path, f"{PREFIX}{step}")
    with open(tmp, "wb") as f:
        msgpack.dump(tree, f)
    os.replace(tmp, target)
    kept = [(s, f) for s, f in _checkpoints(path) if s <= step]
    for s, f in _checkpoints(path):
        if s > step:
            os.remove(f)
    if keep is not None and len(kept) > keep:
        for _, f in kept[:-keep]:
            os.remove(f)
    return target


def _resolve(path: str, step: Optional[int]) -> Optional[str]:
    if os.path.isfile(path):
        return path
    if step is not None:
        file = os.path.join(path, f"{PREFIX}{step}")
        if not os.path.exists(file):
            raise FileNotFoundError(f"no checkpoint {file}")
        return file
    found = _checkpoints(path)
    return found[-1][1] if found else None


def load_checkpoint(path: str, state=None, step: Optional[int] = None,
                    use_bfloat16_weights: bool = False):
    """Read ``path`` (a ``ckpt_<step>`` file, or a directory: its newest
    checkpoint by step number, or ``ckpt_<step>``), written by either
    package or by the reference's release, and decompress f16 leaves to f32.

    With ``state`` (a port ``TrainState``) the file is loaded into it in
    place and the state returned; with none the raw tree (CPU tensors) is
    returned, its params in bf16 under ``use_bfloat16_weights``. A directory
    with no checkpoint gives ``state`` back unchanged (None without one)."""
    file = _resolve(path, step)
    if file is None:
        return state
    if os.path.isdir(file):
        if any(os.path.exists(os.path.join(file, f)) for f in _ORBAX_FILES):
            raise ValueError(
                f"{file} is an orbax checkpoint directory, not a flax-msgpack file: write it "
                "from the JAX package with flax.config.update("
                "'flax_use_orbax_checkpointing', False)")
        raise ValueError(f"{file} is a directory, not a checkpoint file")
    tree = decompress_state(msgpack.load(file))
    if state is not None:
        return load_state_from_flax(state, tree)
    if use_bfloat16_weights and "params" in tree:
        tree = dict(tree, params=f32_to_bf16(tree["params"]))
    return tree


class AsyncCheckpointer:
    """Checkpoint writes off the training loop's critical path.

    ``save`` takes a snapshot of the state on its device: ``state_to_flax``
    with every leaf copied, f32 leaves straight to f16, enqueued on the
    current stream, so it is ordered before the next step's in-place
    updates and the host does not wait. A background thread then copies the
    snapshot to pinned host memory on a stream of its own (behind an event
    recorded after the snapshot, not behind the next steps), and writes it. At most one save is in flight: ``save`` first waits for the last
    one. Call ``wait()`` before exiting; it raises what the write raised.
    Costs a transient copy of the train state in device memory (half of it,
    the parameters, in f16)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state, path: str, **kw) -> None:
        distributed.refuse_standin("AsyncCheckpointer.save")
        self.wait()
        snapshot = _map_leaves(lambda x: x.to(torch.float16) if x.dtype == torch.float32
                               else x.clone(), state_to_flax(state))
        device = next((x.device for x in _leaves(snapshot) if x.is_cuda), None)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record()

        def write():
            try:
                if device is None:
                    host = snapshot
                else:  # on a side stream: the copies wait for the snapshot only
                    with torch.cuda.device(device):
                        stream = torch.cuda.Stream()
                        stream.wait_event(event)
                        with torch.cuda.stream(stream):
                            host = _map_leaves(_to_pinned, snapshot)
                        stream.synchronize()
                _write(host, path, kw.get("keep"), kw.get("overwrite", True))
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def _to_pinned(x: torch.Tensor) -> torch.Tensor:
    """Start the copy of ``x`` to pinned host memory on the current stream:
    a copy to pageable memory is staged by the driver, and stalls the
    training thread's launches while it runs."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# per-rank sharded checkpoints (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

LAYOUT_FILE = "layout.json"
_SHARDED_FORMAT = "merlot_reserve_tpu_torch.sharded/1"
_KINDS = ("params", "mu", "nu", "anchor")


def _state_parts(state):
    """(optimizer, its masters / moments / anchor by master key, the plan or
    None) of a port ``TrainState``, sharded or not."""
    opt = state.optimizer
    if hasattr(opt, "inner"):  # ShardedOptimizer
        inner = opt.inner
        return opt, {"params": inner.params, "mu": inner.mu, "nu": inner.nu,
                     "anchor": inner.anchor}, opt.plan
    return opt, {"params": dict(state.model.named_parameters()), "mu": opt.mu, "nu": opt.nu,
                 "anchor": opt.anchor}, None


def _own_pieces(plan, tensors) -> Dict[str, Tuple[str, bool]]:
    """This rank's masters: master key -> (the key of its share in the
    checkpoint, whether this rank writes it). Without a plan (one process)
    every entry is whole and written here. Each share is written by one
    rank: a ZeRO-1 shard by its dp rank at tp, sp, pp and dcn index 0; an
    entry outside ZeRO-1 by the dp, sp and dcn index 0 ranks of its pp
    stage, each tp rank its own share of a tp-split entry."""
    if plan is None:
        return {n: (n, True) for n in tensors["params"]}
    mesh = plan.mesh
    idx = {a: mesh.axis_index(a) for a in mesh.axis_names}
    out = {}
    for path in plan.zero_leaves():
        out[path] = (f"{path}#dp{idx['dp']}",
                     idx["tp"] == idx["sp"] == idx["pp"] == idx["dcn"] == 0)
    zero_names = set(plan.zero_names())
    for name in plan.full_shapes:
        if name in zero_names:
            continue
        if plan.stage and name in plan.stage and plan.stage[name] != idx["pp"]:
            continue  # another stage's entry
        split = plan.tp_kind.get(name) is not None
        owner = (idx["dp"] == idx["sp"] == idx["dcn"] == 0
                 and plan.stage.get(name, 0) == idx["pp"] and (split or idx["tp"] == 0))
        out[name] = (f"{name}#tp{idx['tp']}" if split else name, owner)
    return out


def _layout(state) -> Dict[str, Any]:
    opt, tensors, plan = _state_parts(state)
    moments = next(iter(tensors["mu"].values())).dtype
    layout = {"format": _SHARDED_FORMAT, "step": int(state.step), "count": int(opt.count),
              "moments": "bf16" if moments == torch.bfloat16 else "f32",
              "anchor": tensors["anchor"] is not None, "mesh": {}, "zero": {}, "tp": {}}
    if plan is not None:
        layout["mesh"] = {a: int(n) for a, n in plan.mesh.shape.items()}
        layout["zero"] = {p: {"dim": plan.zero_dim[p], "names": plan.leaves[p].names,
                              "stacked": plan.leaves[p].stacked} for p in plan.zero_leaves()}
        layout["tp"] = {n: k for n, k in plan.tp_kind.items() if k is not None}
    return layout


def _group(plan):
    """The process group of a checkpoint's collectives: gloo over the
    mesh's ranks (the mesh's own group where it is gloo, else one made once:
    an async save runs its collectives on a thread of its own, beside the
    step's NCCL ones); None for a state of one process outside any job."""
    import torch.distributed as dist

    if plan is None or not dist.is_initialized():
        return None
    mesh = plan.mesh
    group = mesh.group(mesh.axis_names)
    if dist.get_backend(group) == "gloo":
        return group
    if getattr(mesh, "_checkpoint_group", None) is None:  # lives as long as the mesh
        mesh._checkpoint_group = dist.new_group(mesh.group_ranks(mesh.axis_names),
                                                backend="gloo")
    return mesh._checkpoint_group


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def _is_writer(group) -> bool:
    if group is None:
        return True
    import torch.distributed as dist

    return dist.get_rank(group) == 0


def _sharded_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path)
                  if n.isdigit() and os.path.isfile(os.path.join(path, n, LAYOUT_FILE)))


class ShardedCheckpointManager:
    """Per-rank sharded checkpoints of a ``TrainState`` in ``path``: the
    counterpart of the JAX package's orbax ``CheckpointManager``. Every rank
    of the state's mesh calls ``save`` and ``restore`` together.

    ``save`` writes ``<path>/<step>/`` through ``<step>.tmp/``, keeping the
    newest ``keep``. With ``async_save`` the loop waits only for a snapshot
    of its shares on the device (copies in their own dtypes, enqueued on
    the current stream), as ``AsyncCheckpointer`` does; a
    thread copies it to pinned host memory on a stream of its own and
    writes it (``torch.distributed.checkpoint.save``, its collectives on a
    gloo group), and the next ``save``, ``wait()`` or ``close()`` renames
    the checkpoint into place."""

    def __init__(self, path: str, keep: Optional[int] = None, async_save: bool = True):
        self.path, self.keep, self.async_save = path, keep, async_save
        self._pending = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def latest_step(self) -> Optional[int]:
        steps = _sharded_steps(self.path)
        return steps[-1] if steps else None

    def save(self, state) -> str:
        """Start (or, without ``async_save``, make) the checkpoint of
        ``state`` at its step; returns its directory."""
        import torch.distributed.checkpoint as dcp

        distributed.refuse_standin("ShardedCheckpointManager.save")
        self.wait()
        _, tensors, plan = _state_parts(state)
        group = _group(plan)
        step = int(state.step)
        tmp, final = (os.path.join(self.path, f"{step}{ext}") for ext in (".tmp", ""))
        if _is_writer(group):
            os.makedirs(self.path, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier(group)
        own = _own_pieces(plan, tensors)
        snapshot = {f"{kind}/{piece}": tensors[kind][key].detach().clone()
                    for kind in _KINDS if tensors[kind] is not None
                    for key, (piece, owner) in own.items() if owner}
        self._pending = (tmp, final, _layout(state), group)
        kw = dict(checkpoint_id=tmp, process_group=group, no_dist=group is None)
        if not self.async_save:
            dcp.save(snapshot, **kw)
            self.wait()
            return final
        device = next((t.device for t in snapshot.values() if t.is_cuda), None)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record()

        def write():
            try:
                host = snapshot
                if device is not None:  # on a side stream: behind the snapshot only
                    with torch.cuda.device(device):
                        stream = torch.cuda.Stream()
                        stream.wait_event(event)
                        with torch.cuda.stream(stream):
                            host = {k: _to_pinned(t) for k, t in snapshot.items()}
                        stream.synchronize()
                dcp.save(host, **kw)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return final

    def wait(self) -> None:
        """Finish the save in flight: its write, then the layout file and the
        rename into place (rank 0, after a barrier), then the pruning."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error, self._pending = self._error, None, None
            raise error
        if self._pending is None:
            return
        tmp, final, layout, group = self._pending
        self._pending = None
        _barrier(group)
        if _is_writer(group):
            with open(os.path.join(tmp, LAYOUT_FILE), "w") as f:
                json.dump(layout, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            steps = _sharded_steps(self.path)
            for step in steps[:-self.keep] if self.keep else []:
                shutil.rmtree(os.path.join(self.path, str(step)))
        _barrier(group)

    close = wait

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()

    def restore(self, state, step: Optional[int] = None):
        """Load ``<path>/<step>`` (default the newest) into ``state`` in
        place and return it; None when there is no sharded checkpoint."""
        import torch.distributed.checkpoint as dcp

        step = self.latest_step() if step is None else step
        if step is None:
            return None
        directory = os.path.join(self.path, str(step))
        with open(os.path.join(directory, LAYOUT_FILE)) as f:
            layout = json.load(f)
        opt, tensors, plan = _state_parts(state)
        mine = _layout(state)
        for key, what in (("moments", "Adam moments"), ("anchor", "finetuning anchor")):
            if layout[key] != mine[key]:
                raise ValueError(f"the checkpoint's {what} ({layout[key]}) are not the "
                                 f"state's ({mine[key]})")
        stored = dcp.FileSystemReader(directory).read_metadata().state_dict_metadata
        same = all(layout[k] == mine[k] for k in ("mesh", "zero", "tp"))
        own = _own_pieces(plan, tensors)
        wanted = ([f"{kind}/{piece}" for kind in _KINDS if tensors[kind] is not None
                   for piece, _ in own.values()] if same else list(stored))
        bufs = {k: torch.empty(tuple(stored[k].size), dtype=stored[k].properties.dtype)
                for k in wanted}
        group = _group(plan)
        dcp.load(bufs, checkpoint_id=directory, process_group=group, no_dist=group is None)
        with torch.no_grad():
            if same:
                for kind in _KINDS:
                    if tensors[kind] is not None:
                        for key, (piece, _) in own.items():
                            tensors[kind][key].copy_(bufs[f"{kind}/{piece}"])
                if plan is not None:
                    opt.inner.count = layout["count"]
                    opt._write_compute_copies()
                else:
                    opt.count = layout["count"]
            else:
                whole = {kind: _whole_entries(layout, bufs, kind) for kind in _KINDS
                         if tensors[kind] is not None}
                if plan is not None:
                    opt.load_full_state(**whole, count=layout["count"])
                else:
                    for kind, entries in whole.items():
                        for name, t in tensors[kind].items():
                            t.copy_(entries[name])
                    opt.count = layout["count"]
        state.step = layout["step"]
        return state


def _whole_entries(layout, bufs, kind: str) -> Dict[str, torch.Tensor]:
    """Every entry's whole tensor of ``kind`` from all ranks' shares."""
    from merlot_reserve_tpu_torch.parallel.sharding import tp_join

    dp, tp = layout["mesh"].get("dp", 1), layout["mesh"].get("tp", 1)
    out: Dict[str, torch.Tensor] = {}
    for path, z in layout["zero"].items():
        full = torch.cat([bufs[f"{kind}/{path}#dp{i}"] for i in range(dp)], 0)
        x = full.movedim(0, z["dim"])
        parts = list(x.unbind(0)) if z["stacked"] else [x]
        for name, part in zip(z["names"], parts):
            out[name] = from_flax_layout(name, part)
    prefix = f"{kind}/"
    for key in bufs:
        if not key.startswith(prefix) or "#dp" in key:
            continue
        name = key[len(prefix):].split("#tp")[0]
        if name in out:
            continue
        split = layout["tp"].get(name)
        out[name] = (tp_join(split, [bufs[f"{prefix}{name}#tp{j}"] for j in range(tp)])
                     if split else bufs[key])
    return out


def sharded_manager(path: str, keep: Optional[int] = None,
                    async_save: bool = True) -> ShardedCheckpointManager:
    """A ``ShardedCheckpointManager`` for ``path`` (the counterpart of
    ``orbax_manager``). Close it, or ``wait()``, before exiting."""
    return ShardedCheckpointManager(path, keep=keep, async_save=async_save)


def save_checkpoint_sharded(state, path: str, keep: Optional[int] = None) -> int:
    """One per-rank sharded save of ``state`` (every rank of its mesh calls
    it), in place when it returns; returns the step. A training loop that
    should not wait for the write keeps a ``sharded_manager`` instead."""
    with sharded_manager(path, keep=keep, async_save=False) as manager:
        manager.save(state)
    return int(state.step)


def load_checkpoint_sharded(path: str, state, step: Optional[int] = None):
    """Restore the newest (or ``step``'s) sharded checkpoint under ``path``
    into ``state``, at whatever layout ``state`` has; returns the state, or
    None when ``path`` holds none."""
    return sharded_manager(path, async_save=False).restore(state, step)


def latest_checkpoint(path: str) -> Tuple[Optional[str], int]:
    """Which format holds the newest checkpoint in ``path``: ("sharded",
    step), ("msgpack", step), or (None, 0). A sharded one wins a tie."""
    sharded = _sharded_steps(path)
    files = [s for s, f in _checkpoints(path) if os.path.isfile(f)]
    if sharded and (not files or sharded[-1] >= files[-1]):
        return "sharded", sharded[-1]
    if files:
        return "msgpack", files[-1]
    return None, 0


# ---------------------------------------------------------------------------
# layer layouts
# ---------------------------------------------------------------------------


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
    if isinstance(first, torch.Tensor):
        return torch.stack(subtrees, 0)
    return np.stack([np.asarray(t) for t in subtrees], 0)


def unstack_layer_params(tree):
    """Inverse of ``stack_layer_params``: 'layers' ([L, ...]) -> 'layer_NN'."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, dict):
            num_layers = next(_leaves(v)).shape[0]
            for i in range(num_layers):
                out[f"layer_{i:02d}"] = _map_leaves(lambda x: x[i], v)
        else:
            out[k] = unstack_layer_params(v)
    return out


def pretrained_params(path: str, scan_layers: bool = True):
    """The parameter tree of the checkpoint at ``path`` (CPU tensors), in the
    scan-stacked layout when ``scan_layers`` (a ``layer_NN`` tree is stacked;
    a stacked one is left as it is), as the JAX package's scripts read a
    pretrained checkpoint."""
    params = load_checkpoint(path)["params"]
    return stack_layer_params(params) if scan_layers else params


# ---------------------------------------------------------------------------
# overview
# ---------------------------------------------------------------------------


def _numpy_dtype_name(leaf) -> str:
    """numpy's name for a leaf's dtype ('float32', 'bfloat16'), '?' without one."""
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return "?" if dtype is None else str(dtype)


def flat_leaves(tree, prefix=""):
    """('/'-joined name, leaf) for every leaf of a nested dict, keys sorted."""
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            yield from flat_leaves(tree[k], name)
        else:
            yield name, tree[k]


def param_overview(params) -> str:
    """Human-readable table of the param tree (name, shape, size, dtype):
    the JAX package's text for the same tree (shapes as tuples, dtypes by
    numpy's names)."""
    lines = []
    total = 0
    for name, leaf in flat_leaves(params):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        size = leaf.numel() if isinstance(leaf, torch.Tensor) else int(getattr(leaf, "size", 0))
        total += size
        lines.append(f"{name:<80s} {str(shape):>20s} "
                     f"{size:>12,d} {_numpy_dtype_name(leaf):>10s}")
    lines.append(f"TOTAL: {total:,d} params")
    return "\n".join(lines)
