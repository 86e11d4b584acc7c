"""The pretraining and finetuning optimizers, without optax.

The port of ``merlot_reserve_tpu/training/optimization.py``'s two chains.
Both start with memory-lean Adam, the first moment stored in bf16 and the
second in a cube-root bf16 encoding that spends the (always non-negative)
sign bit as an extra mantissa bit, and end with a schedule and the step -lr.
With ``use_bfloat16_adam`` off the moments are f32 and the arithmetic is
optax's ``scale_by_adam`` (bias correction always on), as in the JAX chains:

  * pretraining (``construct_train_state``): decoupled weight decay toward
    zero on the parameters whose flax leaf has more than one axis, then the
    linear-warmup / cosine schedule;
  * finetuning (``construct_finetuning_train_state``): ``subtract_old_weights``,
    decay toward a bf16 anchor of the initial parameters (kept in the
    optimizer state) on the leaves with more than one axis and more than
    4096 elements, then the linear-warmup / linear-decay schedule.

The update math is f32 and follows the optax chain operation for
operation, so that the two packages agree to rounding. On the card one
launch of the hand-written kernel ``csrc/adam_update.cu`` updates every
parameter (``adam_update``); on the CPU its plain version
``adam_update_reference`` runs the eager ops tensor by tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch import kernels
from merlot_reserve_tpu_torch.kernels import build

# one extra half-step of mantissa, signaled by the sign bit
_MISSING_PRECISION = 1 + (1 / 2 ** 9)
_F32_TINY = torch.finfo(torch.float32).tiny  # the smallest normal f32


def unsigned_bfloat16_decode(v: torch.Tensor) -> torch.Tensor:
    """Decode the cube-root bf16 encoding back to f32. torch has no cbrt:
    the cube root is pow(x, 1/3), which can differ from a correctly rounded
    cbrt in the last ulp or two."""
    v_abs = v.abs().float()
    v_abs = torch.where(v >= 0, v_abs, v_abs * _MISSING_PRECISION)
    return torch.pow(v_abs, 1.0 / 3.0)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _F32_TINY, 0.0, x)


def unsigned_bfloat16_encode(v: torch.Tensor) -> torch.Tensor:
    """Encode a non-negative f32 as bf16 of v^3, choosing the sign that
    minimizes the decode error. Subnormal intermediates are flushed to zero
    as XLA does on the CPU and the TPU: the error terms of a nu below about
    1e-12 are subnormal, and the flush decides its half-step bit."""
    v_pow = _flush_subnormal(v * v * v)
    v_bf = v_pow.to(torch.bfloat16)
    v_bf32 = v_bf.float()
    err0 = _flush_subnormal((v_bf32 - v_pow).abs())
    err1 = _flush_subnormal((v_bf32 * _MISSING_PRECISION - v_pow).abs())
    return torch.where(err0 < err1, v_bf, -v_bf)


def lr_scale_linearwarmup_cosinedecay(num_warmup_steps: int, num_train_steps: int,
                                      final_lr_scale: float = 0.1):
    """step -> f32 scale: step / warmup, then a cosine from 1 down to
    ``final_lr_scale`` over the remaining steps."""
    if num_warmup_steps > num_train_steps:
        raise ValueError("num_warmup_steps > num_train_steps")

    def schedule(step: int) -> torch.Tensor:
        step_f = torch.tensor(step, dtype=torch.float32)
        if step < num_warmup_steps:
            return step_f / num_warmup_steps
        post = torch.clamp((step_f - num_warmup_steps) / (num_train_steps - num_warmup_steps + 1.0),
                           max=1.0)
        post = 1.0 - (1.0 - torch.cos(math.pi * post)) / 2.0
        return final_lr_scale + (1.0 - final_lr_scale) * post

    return schedule


def lr_scale_linearwarmup_lineardecay(num_warmup_steps: int, num_train_steps: int):
    """step -> f32 scale: step / warmup, then linear down to 0."""
    if num_warmup_steps > num_train_steps:
        raise ValueError("num_warmup_steps > num_train_steps")

    def schedule(step: int) -> torch.Tensor:
        step_f = torch.tensor(step, dtype=torch.float32)
        if step < num_warmup_steps:
            return step_f / num_warmup_steps
        post = (step_f - num_warmup_steps) / (num_train_steps - num_warmup_steps + 1.0)
        return 1.0 - torch.clamp(post, max=1.0)

    return schedule


CHAINS = ("pretrain", "finetune")


def bias_correction(decay: float, count: int, f32_moments: bool) -> float:
    """1 - decay^count as a Python float. optax's ``scale_by_adam`` (f32
    moments) takes the power and the difference in f32, which moves 1 -
    0.98^t off its exact value by up to a relative 1e-6; the bf16 chain keeps
    the double it has always used."""
    if f32_moments:
        return float(np.float32(1) - np.float32(decay) ** np.float32(count))
    return 1 - decay ** count


@torch.no_grad()
def adam_update_reference(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                          mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                          decay, opt_config, count_inc: int, step_size: float,
                          anchor: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Plain PyTorch version of the update kernel: one update of every
    parameter, mu and nu in place, with eager ops tensor by tensor. f32
    moments (``use_bfloat16_adam`` off) are read and stored as they are,
    optax's ``scale_by_adam``; bf16 ones through the bf16 cast and the
    cube-root code.

    :param decay: the names that take weight decay (pretraining) or are
        pulled toward ``anchor`` (finetuning)
    :param count_inc: the update's count, 1 for the first update
    :param step_size: the schedule's f32 scale at ``count_inc - 1``
    :param anchor: bf16 initial parameters: given, the finetuning chain
    """
    cfg = opt_config
    b1, b2 = cfg.beta_1, cfg.beta_2
    for name, p in params.items():
        g = grads[name]
        f32 = mu[name].dtype == torch.float32
        next_m = (1 - b1) * g + b1 * mu[name].float()
        next_v = (1 - b2) * torch.square(g) + b2 * (
            nu[name] if f32 else unsigned_bfloat16_decode(nu[name]))
        mu[name].copy_(next_m if f32 else next_m.to(torch.bfloat16))
        nu[name].copy_(next_v if f32 else unsigned_bfloat16_encode(next_v))
        if cfg.do_bias_correction:
            next_m = next_m / bias_correction(b1, count_inc, f32)
            next_v = next_v / bias_correction(b2, count_inc, f32)
        update = next_m / (torch.sqrt(next_v) + cfg.eps)
        if name in decay:
            if anchor is None:
                update = update + cfg.weight_decay_rate * p
            else:
                update = update + cfg.weight_decay_rate * (p - anchor[name].float())
        update = update * step_size
        p.add_(update * (-cfg.learning_rate))


# ---------------------------------------------------------------------------
# the kernel: csrc/adam_update.cu
# ---------------------------------------------------------------------------

CHUNK = 8192  # elements per block


class _AdamTensor(ctypes.Structure):
    """Field for field the ``AdamTensor`` struct of csrc/adam_update.cu."""

    _fields_ = [("p", ctypes.c_void_p), ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("anchor", ctypes.c_void_p), ("numel", ctypes.c_int64),
                ("decay", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _AdamHyper(ctypes.Structure):
    """Field for field the ``AdamHyper`` struct of csrc/adam_update.cu."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "one_minus_b1", "b1", "one_minus_b2", "b2", "eps", "inv_bc1", "inv_bc2", "wd",
        "step_size", "neg_lr", "one_third")] + [("bias_correction", ctypes.c_int32),
                                                 ("finetune", ctypes.c_int32),
                                                 ("f32_moments", ctypes.c_int32)]


class _AdamParams(ctypes.Structure):
    """Field for field the ``AdamParams`` struct of csrc/adam_update.cu."""

    _fields_ = [("tensors", ctypes.c_void_p), ("grads", ctypes.c_void_p),
                ("block_tensor", ctypes.c_void_p), ("block_start", ctypes.c_void_p),
                ("num_blocks", ctypes.c_int32), ("chunk", ctypes.c_int32), ("h", _AdamHyper)]


@functools.lru_cache(maxsize=None)
def _adam_lib() -> ctypes.CDLL:
    lib = build.load("adam_update")
    for fn, struct in (("adam_update_params_size", _AdamParams),
                       ("adam_update_tensor_size", _AdamTensor)):
        size = getattr(lib, fn)
        size.argtypes = []
        size.restype = ctypes.c_size_t
        if size() != ctypes.sizeof(struct):
            raise RuntimeError(f"csrc/adam_update.cu's struct does not match {struct.__name__}")
    lib.adam_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.adam_update.restype = ctypes.c_int
    lib.adam_decode_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_void_p]
    lib.adam_decode_probe.restype = ctypes.c_int
    return lib


def _f32(x) -> float:
    return float(np.float32(x))


def adam_hyper(opt_config, count_inc: int, step_size: float, finetune: bool) -> _AdamHyper:
    """The f32 scalars that the eager ops of ``adam_update_reference`` see on
    the card: each Python float rounded to f32, and a tensor divided by a
    Python scalar as a product with the scalar's f32 reciprocal (what
    PyTorch's CUDA division by a scalar computes). The moments' mode is
    ``opt_config.use_bfloat16_adam``'s."""
    cfg = opt_config
    b1, b2 = cfg.beta_1, cfg.beta_2
    f32 = not cfg.use_bfloat16_adam
    inv_bc = [float(np.float32(1.0) / np.float32(bias_correction(b, count_inc, f32)))
              for b in (b1, b2)]
    return _AdamHyper(
        one_minus_b1=_f32(1 - b1), b1=_f32(b1), one_minus_b2=_f32(1 - b2), b2=_f32(b2),
        eps=_f32(cfg.eps), inv_bc1=inv_bc[0], inv_bc2=inv_bc[1],
        wd=_f32(cfg.weight_decay_rate), step_size=_f32(step_size),
        neg_lr=_f32(-cfg.learning_rate), one_third=_f32(1.0 / 3.0),
        bias_correction=int(bool(cfg.do_bias_correction)), finetune=int(finetune),
        f32_moments=int(f32))


class AdamTable:
    """The kernel's device-side table of (param, mu, nu, anchor, numel,
    decay) entries and its block map, built once for tensors that are then
    updated in place. Each update sends only the gradient pointers, and
    refuses to launch if a tensor of the state is no longer the one the
    table points at (a rebound entry, or a parameter moved or cast). The
    moments are all bf16 or all f32 (``moment_dtype``)."""

    def __init__(self, params: Dict[str, torch.Tensor], mu, nu, decay, anchor=None):
        self.names = list(params)
        first = params[self.names[0]]
        self.device = first.device
        if self.device.type != "cuda":
            raise ValueError("adam_update: the kernel's table lives on the card")
        self.moment_dtype = mu[self.names[0]].dtype
        if self.moment_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"adam_update: moments must be bf16 or f32, not {self.moment_dtype}")
        for n in self.names:
            p, m, v = params[n], mu[n], nu[n]
            a = None if anchor is None else anchor[n]
            for what, x, dtype in (("param", p, torch.float32), ("mu", m, self.moment_dtype),
                                   ("nu", v, self.moment_dtype),
                                   ("anchor", a, torch.bfloat16)):
                if x is None:
                    continue
                if (x.dtype != dtype or x.device != self.device or x.shape != p.shape
                        or not x.is_contiguous()):
                    raise ValueError(f"adam_update: {what} of {n} must be a contiguous "
                                     f"{dtype} {tuple(p.shape)} on {self.device}")
        self.state = (params, mu, nu, anchor)
        self.pointers = [self._pointers(n) for n in self.names]
        # aliases of the storages the table points at, so that the kernel
        # never writes into freed memory, whatever the dicts come to hold
        self._held = [tuple(None if d is None else d[n].detach() for d in self.state)
                      for n in self.names]
        entries = (_AdamTensor * len(self.names))(*[
            _AdamTensor(*ptrs, params[n].numel(), int(n in decay), 0)
            for n, ptrs in zip(self.names, self.pointers)])
        self.tensors = torch.frombuffer(bytearray(entries), dtype=torch.uint8).to(self.device)
        chunks = [-(-params[n].numel() // CHUNK) for n in self.names]
        self.block_tensor = torch.repeat_interleave(
            torch.arange(len(chunks), dtype=torch.int32), torch.tensor(chunks)).to(self.device)
        self.block_start = torch.cat([torch.arange(c, dtype=torch.int64) * CHUNK
                                      for c in chunks]).to(self.device)
        self.shapes = [params[n].shape for n in self.names]

    def _pointers(self, name: str) -> Tuple[int, int, int, int]:
        params, mu, nu, anchor = self.state
        return (params[name].data_ptr(), mu[name].data_ptr(), nu[name].data_ptr(),
                0 if anchor is None else anchor[name].data_ptr())

    def grad_pointers(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        ptrs = []
        for n, shape, built in zip(self.names, self.shapes, self.pointers):
            if self._pointers(n) != built:
                raise RuntimeError(f"adam_update: the param, mu, nu or anchor of {n} is no "
                                   "longer the tensor the kernel's table was built from; "
                                   "update the optimizer's state in place")
            g = grads[n]
            if (g.dtype != torch.float32 or g.device != self.device or g.shape != shape
                    or not g.is_contiguous()):
                raise ValueError(f"adam_update: the gradient of {n} must be a contiguous "
                                 f"f32 {tuple(shape)} on {self.device}")
            ptrs.append(g.data_ptr())
        return torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(self.device,
                                                                     non_blocking=True)


def adam_update(table: AdamTable, grads: Dict[str, torch.Tensor], hyper: _AdamHyper) -> None:
    """One launch of csrc/adam_update.cu on PyTorch's current stream: every
    tensor of ``table`` updated from ``grads`` (kept alive by the caller
    until the launch is enqueued; the stream orders any reuse). ``hyper``'s
    moment mode must be the table's."""
    if bool(hyper.f32_moments) != (table.moment_dtype == torch.float32):
        raise ValueError(f"adam_update: {'f32' if hyper.f32_moments else 'bf16'} moment mode "
                         f"for a table of {table.moment_dtype} moments")
    ptrs = table.grad_pointers(grads)
    params = _AdamParams(tensors=table.tensors.data_ptr(), grads=ptrs.data_ptr(),
                         block_tensor=table.block_tensor.data_ptr(),
                         block_start=table.block_start.data_ptr(),
                         num_blocks=table.block_tensor.numel(), chunk=CHUNK, h=hyper)
    with torch.cuda.device(table.device):
        err = _adam_lib().adam_update(ctypes.byref(params),
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_update launch failed with cudaError_t {err}")
    kernels.LAUNCHES["adam_update"] += 1


def adam_decode_probe(nu: torch.Tensor) -> torch.Tensor:
    """The kernel's decode of a contiguous bf16 CUDA tensor, alone: for the
    exhaustive check of its 65536 inputs against ``unsigned_bfloat16_decode``
    (not on any training path; not counted)."""
    if nu.dtype != torch.bfloat16 or nu.device.type != "cuda" or not nu.is_contiguous():
        raise ValueError("adam_decode_probe: needs a contiguous bf16 CUDA tensor")
    out = torch.empty(nu.shape, dtype=torch.float32, device=nu.device)
    with torch.cuda.device(nu.device):
        err = _adam_lib().adam_decode_probe(nu.data_ptr(), out.data_ptr(), nu.numel(),
                                            _f32(1.0 / 3.0),
                                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_decode_probe launch failed with cudaError_t {err}")
    return out


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class PretrainOptimizer:
    """bf16 Adam -> weight decay -> schedule -> -lr, over named f32
    parameters, updated in place, with mu, nu (and the anchor) in place.
    With ``opt_config.use_bfloat16_adam`` off, mu and nu are f32 (optax's
    ``scale_by_adam``, which needs ``do_bias_correction``).

    :param named_params: (name, parameter) pairs, e.g. ``model.named_parameters()``
    :param decay: names of the parameters that take weight decay
        (pretraining) or are pulled toward the anchor (finetuning)
    :param opt_config: an ``OptimizerConfig``
    :param chain: "pretrain" (decay toward zero, cosine schedule) or
        "finetune" (decay toward a bf16 anchor of the parameters as they are
        now, linear schedule)

    ``count`` is the number of updates made. Like optax's
    ``scale_by_schedule``, the schedule is read at the count before the
    update, so the first update has scale schedule(0) = 0 under warmup. On
    the card each update is one launch of ``adam_update``; on the CPU it is
    ``adam_update_reference``.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], decay: Iterable[str],
                 opt_config, chain: str = "pretrain"):
        if not (opt_config.use_bfloat16_adam or opt_config.do_bias_correction):
            raise ValueError("f32 Adam (use_bfloat16_adam off) is optax's scale_by_adam, "
                             "which always corrects the bias")
        if chain not in CHAINS:
            raise ValueError(f"chain must be one of {CHAINS}, got {chain!r}")
        self.config = opt_config
        self.chain = chain
        self.params: Dict[str, torch.Tensor] = dict(named_params)
        self.decay = frozenset(decay)
        unknown = self.decay - set(self.params)
        if unknown:
            raise KeyError(f"weight decay names no parameter: {sorted(unknown)}")
        if chain == "pretrain":
            self.schedule = lr_scale_linearwarmup_cosinedecay(
                opt_config.num_warmup_steps, opt_config.num_train_steps,
                opt_config.final_lr_scale)
            self.anchor = None
        else:
            self.schedule = lr_scale_linearwarmup_lineardecay(
                opt_config.num_warmup_steps, opt_config.num_train_steps)
            self.anchor = {n: p.detach().to(torch.bfloat16) for n, p in self.params.items()}
        moment = torch.bfloat16 if opt_config.use_bfloat16_adam else torch.float32
        self.mu = {n: torch.zeros_like(p, dtype=moment) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=moment) for n, p in self.params.items()}
        self.count = 0
        self._table: Optional[AdamTable] = None

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of every parameter from its f32 gradient."""
        count_inc = self.count + 1
        # an f32 value as a Python float: multiplying by it is exact in f32,
        # and it needs no copy to the device
        step_size = float(self.schedule(self.count))
        device = next(iter(self.params.values())).device
        if device.type == "cuda":
            state = (self.params, self.mu, self.nu, self.anchor)
            if self._table is None:
                self._table = AdamTable(self.params, self.mu, self.nu, self.decay, self.anchor)
            elif any(a is not b for a, b in zip(self._table.state, state)):
                raise RuntimeError("adam_update: the optimizer's params, mu, nu or anchor "
                                   "dict was replaced; update it in place")
            adam_update(self._table, grads,
                        adam_hyper(self.config, count_inc, step_size, self.anchor is not None))
        else:
            adam_update_reference(self.params, grads, self.mu, self.nu, self.decay, self.config,
                                  count_inc, step_size, self.anchor)
        self.count = count_inc


# ---------------------------------------------------------------------------
# across processes: ZeRO-1
# ---------------------------------------------------------------------------


_FLAT_ALIGN = 256  # elements: 512 bytes of bf16 copies, 1024 of f32 masters


class ShardedOptimizer:
    """``PretrainOptimizer`` on a process mesh: this rank's share of the f32
    masters and Adam moments, the model holding the compute copies.

    The port of the JAX package's ZeRO-1 train state (``state_shardings``
    with ``zero1``, ``constrain_params_for_use``). Its ``plan``
    (``parallel.sharding.ShardPlan``) says where each entry lives:

      * a leaf whose spec names dp: the rank's slice of the leaf in its flax
        layout, dp dim in front (contiguous), f32 master and moments here;
        its gradient arrives by one reduce-scatter over dp of all such
        leaves, and after the update one all-gather over dp of their
        compute-dtype casts rebuilds the model's copies;
      * any other entry (tp or pp shares, and everything without ZeRO-1):
        the rank's tensor whole, its gradient summed by one all-reduce over
        the batch axes of all such entries.

    Entries whose gradient is a sum of parts over another axis as well
    (``plan.partial``: an encoder's layers under a sequence split across
    processes) are all-reduced over it first. Entries replicated over sp
    or pp (everything outside a split encoder; the towers and heads, which
    every pipeline stage holds) take the reduced gradient of the first rank
    along that axis, one broadcast per axis, so that their replicas see the
    same update and stay equal bit for bit (the card's backward sums in
    another order on every rank: dq's atomics). Every update is one
    ``adam_update`` launch over this rank's masters on the card (the plain
    loop on the CPU). The model's parameters become the compute copies, in
    ``compute_dtype`` (bf16 under the bf16-gradient policy): the step
    differentiates at them, so their gradients move in that dtype. The
    entries outside ZeRO-1 keep their masters, and their compute copies,
    as views of one flat buffer each, so that their cast, ``nan_to_num`` and
    refresh are one operation each, not one per tensor.

    :param model: the model, already cut to this rank's share
        (``plan.shard_model_``), its parameters the f32 values to start from
    :param decay: the full model's weight-decay names (``weight_decay_names``)
    """

    def __init__(self, model: torch.nn.Module, plan, opt_config, decay: Iterable[str],
                 chain: str = "pretrain", compute_dtype: torch.dtype = torch.bfloat16):
        self.plan = plan
        self.model = model
        self.compute_dtype = compute_dtype
        self.params = dict(model.named_parameters())
        self.zero_paths = plan.zero_leaves()
        zero_names = set(plan.zero_names())
        self.others = [n for n in self.params if n not in zero_names]
        decay = frozenset(decay)
        self._sizes = [self.params[n].numel() for n in self.others]
        # each entry starts on a 512-byte boundary, as the allocator's own
        # tensors do: the card's libraries choose their kernels by alignment
        self._offsets, end = [], 0
        for size in self._sizes:
            self._offsets.append(end)
            end += -(-size // _FLAT_ALIGN) * _FLAT_ALIGN
        device = next(iter(self.params.values())).device
        self._flat_master = torch.zeros(end, dtype=torch.float32, device=device)
        self._flat_compute = torch.zeros(end, dtype=compute_dtype, device=device)
        masters = {}
        with torch.no_grad():
            for path in self.zero_paths:
                whole = plan.leaf_tensor(path, self.params)
                masters[path] = plan.zero_slice(path, whole).float().clone()
            for n, master, compute in zip(self.others, self._split(self._flat_master),
                                          self._split(self._flat_compute)):
                p = self.params[n]
                masters[n] = master.view(p.shape)
                masters[n].copy_(p.detach())
                p.data = compute.view(p.shape)
        decay_keys = [k for k in masters
                      if (plan.leaves[k].names[0] if k in plan.leaves else k) in decay]
        self.inner = PretrainOptimizer(masters.items(), decay_keys, opt_config, chain)
        self._replicated = self._replicated_masters()
        self._write_compute_copies()

    def _replicated_masters(self) -> List[Tuple[str, List[str]]]:
        """(axis, the masters replicated over it), for sp and pp where they
        have more than one rank: over pp every master outside a stage, over
        sp every master whose gradient is not summed over sp."""
        plan, shape = self.plan, self.plan.mesh.shape
        out = []
        for axis in ("sp", "pp"):
            if shape.get(axis, 1) == 1:
                continue
            keys = []
            for k in self.inner.params:
                names = plan.leaves[k].names if k in plan.leaves else [k]
                held = (any(n in plan.stage for n in names) if axis == "pp" else
                        all(axis in plan.partial.get(n, ()) for n in names))
                if not held:
                    keys.append(k)
            if keys:
                out.append((axis, keys))
        return out

    @property
    def count(self) -> int:
        return self.inner.count

    def _batch(self):
        from merlot_reserve_tpu_torch.parallel.mesh import batch_axes

        return batch_axes(self.plan.mesh)

    def held_bytes(self) -> Dict[str, int]:
        """This rank's bytes as allocated: the model's compute copies, the
        f32 masters, each moment, and the alignment padding that the flat
        buffers of the entries outside ZeRO-1 hold (f32 masters, compute
        copies)."""
        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors)

        others = set(self.others)
        pad = self._flat_master.numel() - sum(self._sizes)
        return {"compute_copies": nbytes(p for n, p in self.params.items() if n not in others)
                + nbytes([self._flat_compute]),
                "masters": nbytes(self.inner.params[p] for p in self.zero_paths)
                + nbytes([self._flat_master]),
                "mu": nbytes(self.inner.mu.values()), "nu": nbytes(self.inner.nu.values()),
                "master_padding": pad * self._flat_master.element_size(),
                "compute_padding": pad * self._flat_compute.element_size()}

    def _split(self, flat: torch.Tensor):
        """The other entries' 1-D views of a flat buffer laid out as the
        masters' (``_offsets``)."""
        return [flat[o:o + n] for o, n in zip(self._offsets, self._sizes)]

    @torch.no_grad()
    def _write_compute_copies(self) -> None:
        """The model's compute copies from the masters: one all-gather over dp
        of the ZeRO leaves' casts, and a cast of every other entry."""
        from merlot_reserve_tpu_torch.parallel import comm

        plan, masters = self.plan, self.inner.params
        if self.zero_paths:
            shards = [masters[p].to(self.compute_dtype) for p in self.zero_paths]
            flat = torch.cat([s.reshape(-1) for s in shards]).reshape(1, -1)
            whole = comm.all_gather(flat, plan.mesh, "dp", what="params")
            dp = whole.shape[0]
            offset = 0
            dst, src = [], []
            for path, s in zip(self.zero_paths, shards):
                cols = whole[:, offset:offset + s.numel()]
                offset += s.numel()
                full = cols.reshape((dp * s.shape[0],) + tuple(s.shape[1:]))
                for n, t in plan.leaf_entries(path, full).items():
                    p = self.params[n]
                    if p.dtype != self.compute_dtype:
                        p.data = torch.empty(p.shape, dtype=self.compute_dtype, device=p.device)
                    dst.append(p.data)
                    src.append(t)
            torch._foreach_copy_(dst, src)
        self._flat_compute.copy_(self._flat_master)

    def _reduce(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's f32 gradient of each of its masters (through
        ``nan_to_num``) from its model entries' gradients."""
        from merlot_reserve_tpu_torch.parallel import comm

        plan, mesh = self.plan, self.plan.mesh
        grads = dict(grads)
        partial: Dict[Tuple[str, ...], list] = {}
        for n, axes in plan.partial.items():
            if n in grads:
                partial.setdefault(axes, []).append(n)
        for axes, names in partial.items():
            flat = comm.all_reduce(torch.cat([grads[n].reshape(-1) for n in names]), mesh, axes,
                                   what="grads")
            for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
                grads[n] = part.view(grads[n].shape)
        reduced = []  # (a flat buffer in the compute dtype, its masters' keys and shapes)
        if self.zero_paths:
            moved = [plan.leaf_tensor(p, grads) for p in self.zero_paths]
            dp = mesh.shape["dp"]
            flat = torch.cat([m.reshape(dp, -1) for m in moved], 1)
            shard = comm.reduce_scatter(flat, mesh, "dp", what="grads")
            if mesh.shape.get("dcn", 1) > 1:
                comm.all_reduce(shard, mesh, "dcn", what="grads")
            reduced.append((shard[0], [(p, (m.shape[0] // dp,) + tuple(m.shape[1:]))
                                       for p, m in zip(self.zero_paths, moved)]))
        if self.others:
            flat = comm.all_reduce(torch.cat([grads[n].reshape(-1) for n in self.others]),
                                   mesh, self._batch(), what="grads")
            reduced.append((flat, [(n, tuple(grads[n].shape)) for n in self.others]))
        views = {k: part.view(shape) for buf, entries in reduced for (k, shape), part in
                 zip(entries, buf.split([math.prod(s) for _, s in entries]))}
        for axis, keys in self._replicated:
            parts = [views[k] for k in keys]
            flat = comm.broadcast(torch.cat([p.reshape(-1) for p in parts]), mesh, axis, 0,
                                  what="grads")
            torch._foreach_copy_(parts, [q.view(p.shape) for p, q in
                                         zip(parts, flat.split([p.numel() for p in parts]))])
        out = {}
        for buf, entries in reduced:
            buf = torch.nan_to_num(buf.float())
            for (k, shape), part in zip(entries, buf.split([math.prod(s) for _, s in entries])):
                out[k] = part.view(shape)
        return out

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from the gradients of this rank's model entries (in
        the compute dtype, this rank's part): reduce, update the shard, and
        rebuild the compute copies."""
        self.inner.step(self._reduce(grads))
        self._write_compute_copies()

    # -- checkpoints: the whole state on every rank, and back --------------

    @torch.no_grad()
    def _whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Entry name -> whole tensor, from per-master tensors of this rank
        (the masters or a moment): the ZeRO leaves gathered over dp, the tp
        shares over tp, and the pp stages' entries broadcast from their
        stage."""
        from merlot_reserve_tpu_torch.parallel import comm

        plan, mesh = self.plan, self.plan.mesh
        out: Dict[str, torch.Tensor] = {}
        for path in self.zero_paths:
            out.update(plan.leaf_entries(path, comm.all_gather(tensors[path], mesh, "dp",
                                                                what="checkpoint")))
        tp = mesh.shape.get("tp", 1)
        for n in self.others:
            t = tensors[n]
            if plan.tp_kind.get(n):
                d = plan.tp_dim(n)
                t = plan.tp_join(n, comm.all_gather(t, mesh, "tp", d, "checkpoint").chunk(tp, d))
            out[n] = t
        if plan.stage:
            example = next(iter(tensors.values()))
            for n in sorted(plan.stage, key=lambda k: (plan.stage[k], k)):
                buf = (out[n].contiguous() if n in out else
                       torch.empty(plan.full_shapes[n], dtype=example.dtype,
                                   device=example.device))
                out[n] = comm.broadcast(buf, mesh, "pp", plan.stage[n], what="checkpoint")
        return {n: out[n].contiguous() for n in plan.full_shapes}

    def full_state(self) -> Dict[str, object]:
        """The whole optimizer state, by entry name, on every rank: f32
        params, bf16 mu and nu (and the finetuning anchor), and the count."""
        inner = self.inner
        return {"params": self._whole(inner.params), "mu": self._whole(inner.mu),
                "nu": self._whole(inner.nu),
                "anchor": None if inner.anchor is None else self._whole(inner.anchor),
                "count": inner.count}

    @torch.no_grad()
    def load_full_state(self, params: Dict[str, torch.Tensor], mu=None, nu=None, anchor=None,
                        count: Optional[int] = None) -> None:
        """Keep this rank's share of a whole state (``full_state``'s dicts,
        on any device): masters, moments, anchor and count, then the
        compute copies."""
        plan, inner = self.plan, self.inner
        for src, dst in ((params, inner.params), (mu, inner.mu), (nu, inner.nu),
                         (anchor, inner.anchor)):
            if src is None or dst is None:
                continue
            device = next(iter(dst.values())).device
            for path in self.zero_paths:
                local = {n: src[n].to(device) for n in plan.leaves[path].names}
                dst[path].copy_(plan.zero_slice(path, plan.leaf_tensor(path, local)))
            for n in self.others:
                dst[n].copy_(plan.local(n, src[n].to(device)))
        if count is not None:
            inner.count = count
        self._write_compute_copies()
