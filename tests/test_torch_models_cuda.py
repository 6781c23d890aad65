"""The moe family (GQA and MLA) and whisper's encoder-decoder on a card,
against the same run on the host.

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_cuda.py

Each SMOKE config (fp32) runs ``serve.prefill`` and teacher-forced
``decode_step``s from the same parameters and tokens on the card and on
the host; the logits agree at rtol/atol 2e-4, the tolerance the host tests
hold the port to against the JAX package.  On the card GQA decode goes
through ``tide_attention`` (one launch a layer a step: at H = KH, a group
of 1), on the host through its plain version; MLA's absorbed decode
launches nothing.  The serving engine serves the moe configs the same way.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.tide_attention import kernel as tide_kernel
from repro_torch.models import serve, transformer as T
from repro_torch.serving.engine import ServingEngine

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _run(params, cfg, batch, tokens, steps, device):
    params, batch = _to(params, device), _to(batch, device)
    with torch.no_grad():
        logits, cache = serve.prefill(params, cfg, batch,
                                      tokens.shape[1] + 4)
        out = [logits]
        for t in range(tokens.shape[1] - steps, tokens.shape[1]):
            logits, cache = serve.decode_step(params, cfg, cache,
                                              tokens[:, t].to(device))
            out.append(logits)
    return torch.stack(out).cpu(), _to(cache, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "whisper-large-v3"])
def test_prefill_and_decode_on_card_match_the_host(card, arch):
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    B, S, steps = 2, 8, 6
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + steps))
                              .astype(np.int32))
    batch = {"tokens": tokens[:, :S]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32))
    want, want_cache = _run(params, cfg, batch, tokens, steps, "cpu")
    before = tide_kernel.launches["tide_attention"]
    got, got_cache = _run(params, cfg, batch, tokens, steps, card)
    launched = tide_kernel.launches["tide_attention"] - before
    assert launched == (0 if cfg.mla is not None else cfg.n_layers * steps)
    torch.testing.assert_close(got, want, **TOL)
    assert set(got_cache) == set(want_cache)
    for key in want_cache:
        torch.testing.assert_close(got_cache[key], want_cache[key], **TOL,
                                   msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_engine_serves_moe_on_card_as_on_the_host(card, arch):
    """Four greedy requests over two slots: the same tokens on both
    devices, and D once a layer a decode step on the card for GQA."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 11, 6, 1)]
    outs = {}
    for dev in ("cpu", "cuda"):
        params = T.init_params(cfg, torch.Generator().manual_seed(4))
        eng = ServingEngine(cfg, params, batch_slots=2, max_seq=32,
                            device=dev)
        before = tide_kernel.launches["tide_attention"]
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_drained()
        outs[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            launched = tide_kernel.launches["tide_attention"] - before
            want = 0 if cfg.mla is not None else \
                cfg.n_layers * eng.decode_steps
            assert launched == want
    assert outs["cuda"] == outs["cpu"]
