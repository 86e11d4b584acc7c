"""Traffic driver ``pretrain``: the program's pretraining step on a pool of
seeded batches, staged on the device in set-up and cycled.

Set-up builds one training state (the seeded weights loaded into the
program's pretrainer, its optimizer) and drives it through the first
``checked_steps`` steps with ``train_step``, the window's own call, on
the pool's first batches, whose rows all differ. Their losses, the first
gradient as the optimizer holds it (its first moment after one step over
1 - beta1) and the parameters' change after the last of them are read
then; the window continues the same state on the next batches. After the
window the reference repeats those steps in float32 from the same weights
and batches.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from frozen import bounds, flops
from frozen.dummy import make_dummy_batch
from harness import checks, weights
from harness.config import port_config
from reference import model as ref
from reference.train import run_steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.B = self.mix["batch_size"]
        self.readings: Dict[str, object] = {}

    # -- inputs ---------------------------------------------------------

    def make_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The pool: token streams from the frozen generator, frames and
        audio drawn on the device, every batch from its own seed."""
        cfg, d, m = self.cfg, self.cfg.data, self.cfg.model
        out = []
        for i in range(self.mix["pool_batches"]):
            host = make_dummy_batch(cfg, self.B, seed=weights.derive(self.seed, f"batch{i}") % 2 ** 32,
                                    num_text_spans=self.mix["num_text_spans"], dense=False)
            batch = {k: torch.from_numpy(v).to(self.device, torch.int64) for k, v in host.items()}
            gen = torch.Generator(device=self.device).manual_seed(
                weights.derive(self.seed, f"dense{i}"))
            batch["images"] = torch.randn(
                (self.B, d.num_segments * m.vit_seq_len, m.vit_patch_size ** 2 * 3),
                generator=gen, device=self.device)
            batch["audio_clips"] = torch.randn(
                (self.B, d.num_segments * d.num_audio_subsegments * m.audio_seq_length,
                 m.audio_num_mels + 1), generator=gen, device=self.device)
            out.append(batch)
        return out

    def make_inputs(self) -> None:
        self.batches = self.make_batches()

    # -- the program ----------------------------------------------------

    def setup(self) -> None:
        from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
        from merlot_reserve_tpu_torch.training.trainer import create_train_state

        pc = port_config(self.cfg)
        w = weights.make(self.cfg, self.seed, self.device)
        self.names = list(w.views)
        model = MerlotReservePretrainer(pc, device="meta").to_empty(device=self.device)
        weights.load_into(model, w)
        del w
        self.state = create_train_state(pc, model)
        self.n_params = sum(p.numel() for p in model.parameters())
        self.make_inputs()
        self.checked_steps()

    def step(self, batch):
        from merlot_reserve_tpu_torch.training import trainer

        return trainer.train_step(self.state, batch)[1]

    def checked_steps(self) -> None:
        """The first steps, read for the comparison with the reference."""
        opt = self.state.optimizer
        losses, head_losses = [], []
        for t in range(self.mix["checked_steps"]):
            info = self.step(self.batches[t % len(self.batches)])
            losses.append(float(info["total"]))
            head_losses.append({k: float(v) for k, v in info.items()
                                if k in ref.HEADS})
            if t == 0:
                self.readings["grad_norms"] = weights.leaf_norms(
                    {n: opt.mu[n].float() / (1 - opt.config.beta_1) for n in self.names},
                    self.names)
        w0 = weights.make(self.cfg, self.seed, self.device)
        params = dict(self.state.model.named_parameters())
        self.readings["change_norms"] = weights.leaf_norms(
            {n: params[n].detach() - w0.views[n] for n in self.names}, self.names)
        self.readings["losses"] = losses
        self.readings["head_losses"] = head_losses
        del w0
        _sync(self.device)

    def iterate(self, i: int) -> None:
        n = self.mix["checked_steps"] + i
        self.step(self.batches[n % len(self.batches)])
        _sync(self.device)

    def window_metrics(self, iterations: int, seconds: float) -> Dict[str, float]:
        return {"train_examples_per_s": iterations * self.B / seconds}

    def host_readings(self, traced: int) -> Dict[str, object]:
        return {}

    def attempted(self, iterations: int):
        return iterations, 0

    # -- what the traced iterations asked of the card -------------------

    def work(self, iterations: int) -> Dict[str, float]:
        cfg, m = self.cfg, self.cfg.model
        H, D = m.num_heads, m.size_per_head
        joint_fwd = m.joint_num_layers * (2 if m.gradient_checkpoint else 1)
        span_fwd = m.span_num_layers * (2 if m.tower_gradient_checkpoint else 1)
        per_batch = []
        for batch in self.batches:
            (jv, js), (sv, ss) = ref.pretraining_labels(cfg, batch, ref.draw(cfg, batch))
            fj = bounds.fwd_bound(jv, js, H, D, "bf16", 2)["bound_ms"]
            fs = bounds.fwd_bound(sv, ss, H, D, "bf16", 2)["bound_ms"]
            bj = bounds.bwd_bounds(jv, js, H, D, "bf16", 2)["both"]["bound_ms"]
            bs = bounds.bwd_bounds(sv, ss, H, D, "bf16", 2)["both"]["bound_ms"]
            per_batch.append((joint_fwd * fj + span_fwd * fs, m.joint_num_layers * bj
                              + m.span_num_layers * bs))
        traced = [per_batch[(self.mix["checked_steps"] + i) % len(per_batch)]
                  for i in range(iterations)]
        return {"flops_per_iteration": flops.pretrain_step_flops(cfg, self.B),
                "peak_flops": flops.PEAK_BF16_FLOPS,
                "flash_fwd_bound_s": sum(t[0] for t in traced) / 1e3,
                "flash_bwd_bound_s": sum(t[1] for t in traced) / 1e3,
                "adam_update_bound_s": iterations * self.n_params
                * bounds.ADAM_BYTES_PER_PARAM["bf16"] / bounds.PEAK_BYTES_PER_S,
                "iterations": iterations}

    # -- after the window -----------------------------------------------

    def release(self) -> None:
        del self.state
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, kind: str = "f32") -> Dict[str, object]:
        w0 = weights.make(self.cfg, self.seed, self.device)
        layout = [(n, tuple(v.shape)) for n, v in w0.views.items()]
        out = run_steps(self.cfg, w0.flat, layout,
                        self.batches[:self.mix["checked_steps"]], ref.Numerics(kind))
        del w0
        return out

    def numbers(self) -> Dict[str, float]:
        return checks.training_numbers(self.readings, self.reference("f32"))

    def control_numbers(self) -> Dict[str, float]:
        return checks.training_numbers(self.reference("fp8"), self.reference("f32"))
