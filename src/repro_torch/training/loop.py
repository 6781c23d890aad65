"""Restartable training loop: auto-resume from the tidestore checkpoint WAL,
straggler watchdog, optional failure injection (tests/chaos engineering).
The JAX package's ``training/loop.py`` on PyTorch.

``run`` is written so that a crash at ANY point (including mid-checkpoint —
the WAL's batch atomicity guarantees a manifest is either fully visible or
absent) resumes from the last durable step.  The train state lives on
``device`` (the card by default); checkpoint values are raw leaf bytes, so
either package resumes the other's run.  ``shardings`` places the restored
state on a mesh (a restart onto another topology,
``CheckpointManager.restore``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.models.base import ModelConfig

from .optimizer import AdamWConfig
from .step import init_train_state, make_train_step
from .straggler import StragglerMonitor


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    seed: int = 0
    fail_at_step: Optional[int] = None    # failure injection (tests)
    straggler_action: str = "log"


def run(cfg: ModelConfig, opt: AdamWConfig, loop: LoopConfig,
        batch_fn: Callable[[int], dict], ckpt_dir: str,
        step_fn: Optional[Callable] = None, shardings=None,
        log_fn: Callable[[str], None] = print,
        device: str = "cuda") -> dict:
    """Train with auto-resume.  ``batch_fn(step)`` gives the step's batch
    on ``device``; ``step_fn`` defaults to ``make_train_step(cfg, opt)``.
    Returns summary metrics."""
    ckpt = CheckpointManager(ckpt_dir, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(loop.seed)
    params, opt_state = init_train_state(cfg, opt, gen)
    state = {"params": params, "opt": opt_state}

    restored, step0 = ckpt.restore(state, shardings=shardings)
    if restored is not None:
        state = restored
        start_step = step0 + 1
        log_fn(f"[loop] resumed from step {step0}")
    else:
        start_step = 0
    del params, opt_state

    step_fn = step_fn if step_fn is not None else make_train_step(cfg, opt)
    monitor = StragglerMonitor(action=loop.straggler_action)
    losses = []
    try:
        for step in range(start_step, loop.total_steps):
            monitor.step_start()
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(state["params"],
                                                 state["opt"], batch)
            state = {"params": params, "opt": opt_state}
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = monitor.step_end(step)
            if step % loop.log_every == 0:
                log_fn(f"[loop] step {step} loss {loss:.4f} "
                       f"({dt*1e3:.0f} ms)")
            if loop.fail_at_step is not None and step == loop.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            if step % loop.checkpoint_every == 0 or \
                    step == loop.total_steps - 1:
                ckpt.save(step, state)
    finally:
        ckpt.close()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "last_step": loop.total_steps - 1,
            "straggler_events": list(monitor.events),
            "resumed_from": step0 if restored is not None else None}
