"""Optimizer: five-group AdamW with cosine warmup and per-group clipping
(counterpart of lvv_tpu/train/optim.py).

The groups and their learning rates are the JAX package's (vat_lidar /
vat_vision / adapter (the adapter, the projector and SAM's VARY net_2 /
net_3) / llm_lora / clip_lora), every other parameter frozen. Each group
clips its gradients by their global norm, then takes an AdamW step, as
optax.chain(clip_by_global_norm, adamw) under optax.multi_transform; the
frozen group is set to zero (its parameters are never touched). With
`grad_accum_steps` > 1 the update follows optax.MultiSteps: gradients are
averaged over k mini-steps and the groups update on the k-th.

`MultiGroupAdamW` works on a dict of fp32 tensors (the train state's
master copies), in place, with optax's arithmetic: mu = b1·mu + (1 - b1)·g,
nu = b2·nu + (1 - b2)·g², the update mu_hat / (sqrt(nu_hat) + eps) plus
weight_decay·p, scaled by -lr(count) with count the group's number of
updates before this one (optax's schedule count).

The detector trains with one chain over all its parameters, `ClipAdamW`
(`detector_optimizer`: optax.chain(clip_by_global_norm(10),
adamw(warmup_cosine_decay_schedule(...)))), on the same AdamW arithmetic,
`adamw_update_`.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping

import torch

from ..config import OptimConfig

GROUPS = ("vat_lidar", "vat_vision", "adapter", "llm_lora", "clip_lora",
          "frozen")
_EPS = 1e-8                 # optax.adamw's eps (eps_root 0)


def param_group(path_keys) -> str:
    """The optimizer group of a parameter path (JAX `param_group`; the
    port's state_dict names split at "." are the JAX tree's paths)."""
    keys = [str(k) for k in path_keys]
    top = keys[0] if keys else ""
    is_lora = any(k in ("lora_a", "lora_b") for k in keys)
    if top in ("vat_lidar", "vat_vision", "adapter"):
        return top
    if top == "deepencoder":
        if is_lora:
            return "clip_lora"           # CLIP LoRA adapters
        if "projector" in keys or "net_2" in keys or "net_3" in keys:
            return "adapter"             # trainable deepencoder pieces
        return "frozen"                  # SAM backbone / neck, CLIP base
    if top == "llm":
        return "llm_lora" if is_lora else "frozen"
    return "frozen"


def _named(params) -> Iterable:
    """(name, tensor) pairs of a module's parameters or a state_dict."""
    if isinstance(params, torch.nn.Module):
        return params.named_parameters()
    return params.items()


def group_labels(params) -> Dict[str, str]:
    """{state_dict name: group} of a module or a {name: tensor} mapping."""
    return {name: param_group(name.split(".")) for name, _ in _named(params)}


def trainable_mask(params) -> Dict[str, bool]:
    return {name: g != "frozen" for name, g in group_labels(params).items()}


def count_by_group(params) -> Dict[str, int]:
    out = {g: 0 for g in GROUPS}
    for name, t in _named(params):
        out[param_group(name.split("."))] += t.numel()
    return out


def make_schedule(base_lr: float, total_steps: int, warmup_ratio: float):
    """optax's warmup_cosine_decay_schedule(base / (warmup + 1), base,
    warmup, max(total, warmup + 1), end 0), or cosine_decay_schedule(base,
    max(total, 1)) without warmup: count -> learning rate, count being the
    number of updates made before."""
    warmup = int(total_steps * warmup_ratio)
    decay = max(total_steps, warmup + 1) if warmup else max(total_steps, 1)
    init = base_lr / (warmup + 1)

    def lr(count: int) -> float:
        if count < warmup:
            return init + (base_lr - init) * count / warmup
        t = min(count - warmup, decay - warmup)
        return base_lr * 0.5 * (1 + math.cos(math.pi * t / (decay - warmup)))
    return lr


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (exponent 1): count -> learning
    rate, a line from init_value to peak_value over warmup_steps, then a
    cosine from peak_value to end_value over decay_steps - warmup_steps
    (which optax requires positive), end_value after."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("the cosine decay requires positive decay_steps - "
                         f"warmup_steps, got {span}")
    alpha = 0.0 if peak_value == 0 else end_value / peak_value

    def lr(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak_value * ((1 - alpha) * cosine + alpha)
    return lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm on a list of tensors -> (clipped, the
    pre-clip norm): each t becomes (t / norm) · max_norm when norm >=
    max_norm (no epsilon, unlike clip_grad_norm_), else stays; no host
    synchronisation."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, t, t / norm * max_norm) for t in grads], norm


@torch.no_grad()
def adamw_update_(params, grads, mu, nu, count: int, lr: float, b1: float,
                  b2: float, weight_decay: float) -> None:
    """One AdamW step in place on lists of tensors, optax's arithmetic:
    the moments move, bias corrections at `count` (the updates made,
    this one included), mu_hat / (sqrt(nu_hat) + eps) + weight_decay · p,
    scaled by -lr."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
    mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
    den = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** count))
    torch._foreach_add_(den, _EPS)
    upd = torch._foreach_div(mu_hat, den)
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)


class ClipAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    weight_decay=weight_decay)) over one set of named tensors, in place:
    the detector's optimizer (`detector_optimizer`). Weight decay and the
    moments' decay reach every tensor; a tensor whose gradient is None
    (no path from the loss to it) takes a zero gradient, as JAX's
    gradient of an unused parameter is zero."""

    def __init__(self, schedule, max_norm: float, b1: float = 0.9,
                 b2: float = 0.999, weight_decay: float = 1e-4):
        self.schedule, self.max_norm = schedule, max_norm
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(t) for n, t in params.items()},
                "nu": {n: torch.zeros_like(t) for n, t in params.items()}}

    @torch.no_grad()
    def update(self, grads: Mapping[str, "torch.Tensor | None"],
               state: dict, params: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
        """One step of every tensor of `params` in place; returns the
        gradients' global norm before the clip."""
        names = list(params)
        g = [grads[n] if grads.get(n) is not None
             else torch.zeros_like(params[n]) for n in names]
        g, norm = clip_by_global_norm(g, self.max_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        adamw_update_([params[n] for n in names], g,
                      [state["mu"][n] for n in names],
                      [state["nu"][n] for n in names], state["count"], lr,
                      self.b1, self.b2, self.weight_decay)
        return norm


def detector_optimizer(lr: float, total_steps: int) -> ClipAdamW:
    """The detector CLI's chain: clip by global norm 10, then AdamW (weight
    decay 1e-4) at warmup_cosine_decay_schedule(lr / 10, lr,
    max(total_steps // 10, 1), total_steps)."""
    return ClipAdamW(warmup_cosine_decay_schedule(
        lr / 10, lr, max(total_steps // 10, 1), total_steps), max_norm=10.0)


class MultiGroupAdamW:
    """The five groups' clip + AdamW over master tensors, MultiSteps
    accumulation on top. `labels`: {name: group}; `lrs`: {group: base lr}."""

    def __init__(self, cfg: OptimConfig, labels: Mapping[str, str],
                 lrs: Mapping[str, float], total_steps: int):
        self.labels = dict(labels)
        self.groups = {g: [n for n, lbl in self.labels.items() if lbl == g]
                       for g in lrs}
        self.schedules = {g: make_schedule(lr, total_steps, cfg.warmup_ratio)
                          for g, lr in lrs.items()}
        self.b1, self.b2 = cfg.betas
        self.weight_decay = cfg.weight_decay
        self.grad_clip = cfg.grad_clip
        self.accum = cfg.grad_accum_steps

    def init(self, masters: Mapping[str, torch.Tensor]) -> dict:
        zeros = {n: torch.zeros_like(masters[n])
                 for names in self.groups.values() for n in names}
        return {"mini_step": 0,
                "acc": {n: t.clone() for n, t in zeros.items()}
                if self.accum > 1 else {},
                "groups": {g: {"count": 0,
                               "mu": {n: zeros[n].clone() for n in names},
                               "nu": {n: zeros[n].clone() for n in names}}
                           for g, names in self.groups.items()}}

    def learning_rates(self, state: dict) -> Dict[str, float]:
        """Each group's learning rate for its next update."""
        return {g: self.schedules[g](state["groups"][g]["count"])
                for g in self.groups}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               masters: Dict[str, torch.Tensor]) -> bool:
        """One mini-step: fold `grads` (fp32, by name) into the average;
        on the k-th, clip and step every group in place. Returns whether
        the masters changed."""
        if self.accum > 1:
            n = state["mini_step"]
            for name, acc in state["acc"].items():
                acc.add_((grads[name] - acc) / (n + 1))
            if n < self.accum - 1:
                state["mini_step"] = n + 1
                return False
            grads = {k: v.clone() for k, v in state["acc"].items()}
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"] = 0
        for g, names in self.groups.items():
            if names:
                self._step_group(g, names, grads, state["groups"][g], masters)
        return True

    def _step_group(self, group: str, names, grads, gs: dict,
                    masters) -> None:
        g = [grads[n] for n in names]
        norm = global_norm(g)
        # clip_by_global_norm, without a host sync
        g = torch._foreach_mul(g, torch.where(norm < self.grad_clip, 1.0,
                                              self.grad_clip / norm))
        lr = self.schedules[group](gs["count"])
        gs["count"] += 1
        adamw_update_([masters[n] for n in names], g,
                      [gs["mu"][n] for n in names],
                      [gs["nu"][n] for n in names], gs["count"], lr,
                      self.b1, self.b2, self.weight_decay)


def make_optimizer(cfg: OptimConfig, params, total_steps: int):
    """-> (MultiGroupAdamW, labels {name: group}) for a module or a
    {name: tensor} mapping (JAX `make_optimizer`)."""
    lrs = {"vat_lidar": cfg.lr_vat_lidar, "vat_vision": cfg.lr_vat_vision,
           "adapter": cfg.lr_adapter, "llm_lora": cfg.lr_llm_lora,
           "clip_lora": cfg.lr_clip_lora}
    labels = group_labels(params)
    return MultiGroupAdamW(cfg, labels, lrs, total_steps), labels
