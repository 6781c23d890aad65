"""AdamW in plain PyTorch, the JAX package's ``training/optimizer.py``.

Not ``torch.optim.AdamW``, whose rules differ from the reference's: weight
decay here is decoupled and applies to leaves of two or more dimensions
only, the learning rate warms up linearly, gradients are clipped by their
global norm, and the moments are stored in ``moment_dtype`` (bf16 for
memory-constrained configs) while every update runs in fp32.  The state
keeps the reference's layout, ``{"m": tree, "v": tree, "step": int32
scalar}``, so a checkpoint of either package restores in the other.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm); the inputs stay as they
    are."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device)
    lr = _schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() >= 2:                      # decoupled weight decay
            update = update + cfg.weight_decay * p.float()
        newp = p.float() - lr * update
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state["m"]),
               leaves(state["v"]))]
    new = [unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, gnorm
