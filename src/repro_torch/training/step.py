"""Train / prefill / decode step factories, the JAX package's
``training/step.py``.

``make_train_step`` runs the forward through ``train_loss``, the backward
with ``torch.autograd.grad`` over every parameter leaf (a leaf the loss
does not reach gets a zero gradient, as under ``jax.value_and_grad``), then
the AdamW update.  ``abstract_train_state`` gives the train state's shapes
without allocation (the JAX package's ``jax.eval_shape``) as meta tensors,
which carry a shape and a dtype and no storage.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import serve as serve_mod
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig

from .optimizer import AdamWConfig, adamw_init, adamw_update


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    compress_grads=None):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics).  ``compress_grads`` optionally transforms the gradient tree
    (e.g. int8 quantize → all-reduce → dequantize,
    ``distributed/compression.py``)."""

    def train_step(params, opt_state, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss = T.train_loss(unflatten(params, flat), cfg, batch)
        grads = unflatten(params, torch.autograd.grad(
            loss, flat, materialize_grads=True))
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, gnorm = adamw_update(
            unflatten(params, [p.detach() for p in flat]), grads, opt_state,
            opt)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """Returns prefill_step(params, batch, cache=None) → (logits, cache):
    ``serve.prefill``, into ``cache`` where one is given."""
    @torch.no_grad()
    def prefill_step(params, batch, cache=None):
        return serve_mod.prefill(params, cfg, batch, max_seq=max_seq,
                                 cache=cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def step(params, cache, tokens, mrope_positions=None):
        return serve_mod.decode_step(params, cfg, cache, tokens,
                                     mrope_positions=mrope_positions)
    return step


def init_train_state(cfg: ModelConfig, opt: AdamWConfig,
                     gen: torch.Generator):
    """(params, opt_state) on the generator's device."""
    params = T.init_params(cfg, gen)
    return params, adamw_init(params, opt)


def abstract_train_state(cfg: ModelConfig, opt: AdamWConfig):
    """(params, opt_state) as meta tensors, built under ``FakeTensorMode``
    (no allocation, also for the 671B config)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = T.init_params(cfg, torch.Generator())
        opt_state = adamw_init(params, opt)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    return tree_map(meta, params), tree_map(meta, opt_state)
