"""Finetuning: the train state, one step with optional microbatching, the
task losses and the prediction steps.

The port of ``merlot_reserve_tpu/finetune/train.py`` with the finetuning
chain of ``construct_finetuning_train_state``
(``training.optimization.PretrainOptimizer(chain="finetune")``). Unlike
the pretraining step, the gradient is taken at the bf16 copy of the
parameters (under ``use_bfloat16_grads``): with ``scan_minibatch`` the
microbatches of one example sum their bf16 gradients in bf16, as the
reference does, and the sum is cast up to f32 once. Then ``nan_to_num`` and
the optimizer, which updates the f32 masters in place. ``run_finetuning``
is the scripts' epoch loop around it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from merlot_reserve_tpu_torch.training.optimization import PretrainOptimizer
from merlot_reserve_tpu_torch.training.trainer import TrainState, weight_decay_names

# the finetuning chain's mask: flax leaves with more than one axis and more
# than this many elements
FINETUNE_DECAY_MIN_SIZE = 4096


def create_finetune_state(cfg, model: torch.nn.Module) -> TrainState:
    """A fresh ``TrainState`` for a finetuning head whose weights are loaded
    (the anchor is their bf16 copy as they are now), with the finetuning
    chain of ``cfg.optimizer``: the port of ``construct_finetuning_train_state``."""
    optimizer = PretrainOptimizer(model.named_parameters(),
                                  weight_decay_names(model, FINETUNE_DECAY_MIN_SIZE),
                                  cfg.optimizer, chain="finetune")
    return TrainState(model=model, optimizer=optimizer)


LossFn = Callable[[torch.nn.Module, Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _info_and_grads(model, params: Dict[str, torch.Tensor], batch, loss_fn: LossFn):
    loss, info = loss_fn(model, params, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
    return {k: v.detach() for k, v in info.items()}, grads


def finetune_train_step(state: TrainState, batch: Dict[str, torch.Tensor], loss_fn: LossFn,
                        scan_minibatch: bool = False, use_bfloat16_grads: bool = True
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step; updates ``state`` in place and returns it with the loss
    function's metrics as 0-d f32 tensors (not synchronised).

    :param loss_fn: ``loss_fn(model, params, batch) -> (loss, metrics)``,
        ``params`` the tensors to run ``model`` with (``vcr_loss_fn``,
        ``tvqa_loss_fn``)
    :param scan_minibatch: one example at a time, the gradients summed in
        their dtype and the sums scaled by 1 / batch size
    """
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    params = {n: (p.detach().to(torch.bfloat16) if use_bfloat16_grads else p.detach())
              .requires_grad_() for n, p in model.named_parameters()}
    if scan_minibatch:
        bsize = next(iter(batch.values())).shape[0]
        info, grads = _info_and_grads(model, params, {k: v[:1] for k, v in batch.items()},
                                      loss_fn)
        for i in range(1, bsize):
            micro = {k: v[i:i + 1] for k, v in batch.items()}
            info_i, grads_i = _info_and_grads(model, params, micro, loss_fn)
            grads = [a + b for a, b in zip(grads, grads_i)]
            info = {k: info[k] + info_i[k] for k in info}
        scale = 1.0 / bsize
        info = {k: v * scale for k, v in info.items()}
        grads = [g * scale for g in grads]
    else:
        info, grads = _info_and_grads(model, params, batch, loss_fn)
    grads = {n: torch.nan_to_num(g).float() for n, g in zip(names, grads)}
    info = {k: v.float() for k, v in info.items()}
    state.optimizer.step(grads)
    state.step += 1
    return state, info


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_p = F.log_softmax(logits, -1)
    labels_oh = F.one_hot(labels.long(), log_p.shape[-1]).to(log_p.dtype)
    return -torch.mean(torch.sum(labels_oh * log_p, -1))


def vcr_loss_fn(model, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy per task, averaged over the two tasks."""
    logits = functional_call(model, params, (batch,))
    loss = _softmax_ce(logits, batch["labels"])
    is_right = (torch.argmax(logits, -1) == batch["labels"]).float().mean()
    return loss, {"is_right": is_right, "loss": loss}


def tvqa_loss_fn(model, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy of the audio stream plus that of the text stream."""
    from_audio, from_text = functional_call(model, params, (batch,))
    loss_audio = _softmax_ce(from_audio, batch["labels"])
    loss_text = _softmax_ce(from_text, batch["labels"])
    return loss_audio + loss_text, {
        "is_right_audio": (torch.argmax(from_audio, -1) == batch["labels"]).float().mean(),
        "is_right_text": (torch.argmax(from_text, -1) == batch["labels"]).float().mean(),
        "loss_audio": loss_audio,
        "loss_text": loss_text,
    }


@torch.no_grad()
def vcr_pred_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
    logits = state.model(batch)
    return {"logprobs": F.log_softmax(logits, -1), "preds": torch.argmax(logits, -1)}


@torch.no_grad()
def tvqa_pred_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
    """Per stream, and jointly: softmax(audio) + softmax(text)."""
    from_audio, from_text = state.model(batch)
    joint = F.softmax(from_audio, -1) + F.softmax(from_text, -1)
    return {"preds_audio": torch.argmax(from_audio, -1),
            "preds_text": torch.argmax(from_text, -1),
            "preds_joint": torch.argmax(joint, -1),
            "logprobs_audio": F.log_softmax(from_audio, -1),
            "logprobs_text": F.log_softmax(from_text, -1)}


def run_finetuning(state: TrainState, batches, loss_fn: LossFn, steps_per_epoch: int,
                   num_epochs: int, mesh=None, scan_minibatch: bool = False,
                   evaluate: Optional[Callable[[TrainState], Dict[str, float]]] = None,
                   output_dir: str = "", log_every: int = 100) -> Dict:
    """The finetuning scripts' loop: ``num_epochs`` epochs of
    ``steps_per_epoch`` ``finetune_train_step``s under ``activate_mesh(mesh)``
    on numpy batches from ``batches`` (``finetune_batches``), each moved to
    the model's device; after each epoch ``evaluate(state)`` (printed) and,
    with an ``output_dir``, a checkpoint without the optimizer.

    :return: {'steps': per step {'step', 'data_ms' (the host's time to
        produce the batch), 'step_ms' (the host's time in the step, which
        waits for the device only on a logged step), and on every
        ``log_every``-th step 'metrics' as floats}, 'evaluations': per epoch
        ``evaluate``'s result}
    """
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.utils.checkpoint import save_checkpoint

    device = next(state.model.parameters()).device
    record = {"steps": [], "evaluations": []}
    for epoch in range(num_epochs):
        for it in range(steps_per_epoch):
            t0 = time.perf_counter()
            batch = batch_to_tensors(next(batches), device)
            t1 = time.perf_counter()
            with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
                state, info = finetune_train_step(state, batch, loss_fn,
                                                  scan_minibatch=scan_minibatch)
            entry = {"step": state.step - 1, "data_ms": (t1 - t0) * 1e3}
            if log_every and (it + 1) % log_every == 0:
                entry["metrics"] = {k: float(v) for k, v in info.items()}
                print(f"epoch {epoch} it {it + 1}: {entry['metrics']}", flush=True)
            entry["step_ms"] = (time.perf_counter() - t1) * 1e3
            record["steps"].append(entry)
        if evaluate is not None:
            with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
                acc = evaluate(state)
            record["evaluations"].append(acc)
            print(f"epoch {epoch}: " + " ".join(f"{k} acc {v:.4f}" for k, v in acc.items()),
                  flush=True)
        if output_dir:
            save_checkpoint(state, output_dir, no_optimizer=True)
    return record
