"""The training step on one card (counterpart of
lvv_tpu/parallel/train_step.py).

JAX keeps every parameter in fp32 and computes in bf16, differentiating
only the trainable partition (the frozen leaves enter as stop_gradient
constants). Here the model holds its working weights in its dtype (bf16 on
the card); the trainable ones require a gradient, and the train state
keeps their fp32 master copies, which the optimizer updates and which are
rounded back into the working weights after each update. Frozen weights
are never written. `make_eval_step` is the teacher-forced validation loss,
without a gradient.

One card only: JAX's data / model mesh (DDP / TP) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..models.layers import set_trainable
from ..models.vqa import VQABatch, VQAModel
from .optim import MultiGroupAdamW, global_norm


@dataclass
class TrainState:
    """step; `masters`: fp32 copies of the trainable parameters by
    state_dict name; the optimizer's state; the dropout generator (on the
    model's device); `frozen`: the model's frozen parameters themselves (not
    copies), so that a checkpoint holds the whole model, as JAX's TrainState
    does."""
    step: int
    masters: Dict[str, torch.Tensor]
    opt_state: dict
    generator: torch.Generator
    frozen: Dict[str, torch.Tensor]

    def state_dict(self) -> dict:
        return {"step": self.step, "masters": self.masters,
                "opt_state": self.opt_state,
                "generator": self.generator.get_state(),
                "frozen": self.frozen}

    @torch.no_grad()
    def load_state_dict(self, data: dict) -> None:
        """Load a `state_dict` (tensors on any device) into this state's
        tensors (the frozen ones into the model)."""
        self.step = int(data["step"])
        _copy_into(self.masters, data["masters"])
        _copy_into(self.frozen, data["frozen"])
        self.opt_state = _copy_into(self.opt_state, data["opt_state"])
        self.generator.set_state(data["generator"].cpu())


def _copy_into(dst, src):
    """src's values in dst's tensors (same structure), returned."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    return src


def create_state(model: VQAModel, tx: MultiGroupAdamW,
                 generator: torch.Generator) -> TrainState:
    """Mark the optimizer's trainable parameters (requires_grad), copy them
    to fp32 masters and initialise the optimizer's state."""
    names = [n for n, g in tx.labels.items() if g != "frozen"]
    set_trainable(model, names)
    params = dict(model.named_parameters())
    masters = {n: params[n].detach().float().clone() for n in names}
    frozen = {n: params[n].data for n, g in tx.labels.items()
              if g == "frozen"}
    return TrainState(step=0, masters=masters, opt_state=tx.init(masters),
                      generator=generator, frozen=frozen)


@torch.no_grad()
def load_masters(model: VQAModel, state: TrainState) -> None:
    """The working weights rounded from the masters (after an update or a
    restore)."""
    params = dict(model.named_parameters())
    names = list(state.masters)
    torch._foreach_copy_([params[n] for n in names],
                         [state.masters[n] for n in names])


def make_train_step(model: VQAModel, tx: MultiGroupAdamW):
    """-> step(state, batch) -> (state, {"loss", "grad_norm", "tokens"}),
    the metrics as device tensors (read them when they are needed: a read
    waits for the card). Dropout is live (deterministic=False), drawn from
    the state's generator; the state is updated in place."""
    params = dict(model.named_parameters())
    names = [n for n, g in tx.labels.items() if g != "frozen"]

    def step(state: TrainState, batch: VQABatch):
        for n in names:
            params[n].grad = None
        loss, _, count = model(batch.to(model.device), deterministic=False,
                               generator=state.generator)
        loss.backward()
        grads = {n: torch.zeros(params[n].shape, device=params[n].device)
                 if params[n].grad is None else params[n].grad.float()
                 for n in names}
        for n in names:
            params[n].grad = None
        gnorm = global_norm(grads.values())
        if tx.update(grads, state.opt_state, state.masters):
            load_masters(model, state)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "tokens": count.float()}

    return step


def make_eval_step(model: VQAModel):
    """-> eval(batch) -> (loss, token count), teacher-forced, no gradient
    (JAX `make_eval_step`)."""
    @torch.no_grad()
    def evaluate(batch: VQABatch):
        loss, _, count = model(batch.to(model.device), deterministic=True)
        return loss, count
    return evaluate
