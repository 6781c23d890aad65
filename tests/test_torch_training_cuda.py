"""The training path on a card, against the same run on the host.

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_training_cuda.py

- One ``make_train_step`` of each family's SMOKE config (fp32) from the
  same parameters and batch on the card and on the host, with no kernel
  launched (the SSM layers train through the plain SSD, so no kernel cuts
  mamba2's graph): the loss agrees at rtol/atol 2e-4, each gradient leaf
  at rtol 2e-4 and atol 2e-4 x the leaf's largest |grad|, and each
  parameter's change on the card at rtol 2e-4 (and one fp32 ulp of the
  parameter) with the host's AdamW update of the card's gradients, at the
  full learning rate from the first step.
- Kernel E's entry refuses inputs that require a gradient.
- A ``CheckpointManager`` on the card saves and restores a train state bit
  for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.tree import (leaves, leaves_with_path, path_str,
                                   tree_map)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.tide_attention import kernel as tide_kernel
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.step import init_train_state, make_train_step

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["llama3-8b", "qwen3-0.6b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
            "deepseek-v3-671b", "mamba2-1.3b", "recurrentgemma-9b",
            "whisper-large-v3"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _launches() -> int:
    return sum(ssd_kernel.launches.values()) + \
        sum(tide_kernel.launches.values())


# The full learning rate from the first step: a missing, doubled or
# sign-flipped update moves a parameter by lr, far beyond the tolerance.
OPT = AdamWConfig(lr=1e-3, warmup_steps=1)


def _flat(tree) -> dict:
    return {path_str(p): t.detach().cpu() for p, t in leaves_with_path(tree)}


def _step(cfg, params, batch, device):
    """One train step on ``device`` → (loss, grads, new params), all on the
    host."""
    grads = []
    step = make_train_step(cfg, OPT, compress_grads=lambda g: grads.append(
        g) or g)
    p = tree_map(lambda t: t.to(device), params)
    new_p, _, metrics = step(p, adamw_init(p, OPT),
                             {k: v.to(device) for k, v in batch.items()})
    host = lambda tree: tree_map(lambda t: t.cpu(), tree)
    return metrics["loss"].cpu(), host(grads[0]), host(new_p)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_card_matches_host(card, arch):
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch_fn(cfg, 2, 16, "cpu")(0)
    want_loss, want_grads, _ = _step(cfg, params, batch, "cpu")
    before = _launches()
    loss, grads, new_p = _step(cfg, params, batch, card)
    assert _launches() == before
    torch.testing.assert_close(loss, want_loss, **TOL)
    want = _flat(want_grads)
    for path, g in _flat(grads).items():
        w = want[path]
        torch.testing.assert_close(g, w, rtol=2e-4,
                                   atol=2e-4 * float(w.abs().max()),
                                   msg=path)
    # The first step moves most entries by lr whatever the gradient's size,
    # so a gradient within rounding of 0 may take another sign on each
    # device: the update is held against the host's AdamW of the card's
    # own gradients, not against the host's step.
    host_p = adamw_update(params, grads, adamw_init(params, OPT), OPT)[0]
    old, want_p = _flat(params), _flat(host_p)
    for path, p in _flat(new_p).items():
        moved = p.double() - old[path].double()
        want_moved = want_p[path].double() - old[path].double()
        ulp = torch.finfo(torch.float32).eps * old[path].double().abs()
        assert bool(((moved - want_moved).abs()
                     <= ulp + 2e-4 * want_moved.abs()).all()), path


@pytest.mark.cuda
def test_ssd_kernel_refuses_inputs_that_require_grad(card):
    b, l, h, p, n = 1, 64, 8, 16, 16
    x = torch.randn((b, l, h, p), device=card)
    dt = torch.rand((b, l, h), device=card)
    A = -torch.rand((h,), device=card)
    Bm, Cm = (torch.randn((b, l, n), device=card) for _ in range(2))
    ssd(x, dt, A, Bm, Cm, chunk=32)
    before = _launches()
    with pytest.raises(ValueError, match="differentiate"):
        ssd(x.requires_grad_(), dt, A, Bm, Cm, chunk=32)
    assert _launches() == before


@pytest.mark.cuda
def test_checkpoint_save_and_restore_on_card(card, tmp_path):
    cfg = get_config("qwen3-0.6b", smoke=True)
    opt = AdamWConfig(moment_dtype="bfloat16")
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, opt_state = init_train_state(cfg, opt, gen)
    state = {"params": params, "opt": opt_state}
    mgr = CheckpointManager(str(tmp_path), chunk_bytes=4096)
    mgr.save(2, state)
    mgr.close()
    mgr = CheckpointManager(str(tmp_path))
    got, step = mgr.restore(state)
    mgr.close()
    assert step == 2
    for (path, a), b in zip(leaves_with_path(got), leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        assert np.array_equal(a.cpu().reshape(-1).view(torch.uint8).numpy(),
                              b.cpu().reshape(-1).view(torch.uint8).numpy())
