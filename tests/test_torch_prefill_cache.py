"""``serve.prefill`` into a cache the caller made (``init_cache``, as the
dry run passes one placed on a mesh) against ``serve.prefill`` making its
own: the same logits and every cache entry equal, and both equal to the
JAX package's prefill at the serving tests' tolerance (rtol/atol 2e-4),
for every cache layout: the dense KV-WAL, vlm, MLA's latent arenas, the
ssm's states, griffin's arenas and recurrent states, and whisper's cross
K/V."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import serve as jax_serve
from repro.models import transformer as jax_T
from repro_torch.configs.registry import get_config
from repro_torch.models import serve
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["llama3-8b", "qwen2-vl-72b", "deepseek-v3-671b", "mamba2-1.3b",
         "recurrentgemma-9b", "whisper-large-v3"]


def _inputs(cfg, B, S, seed):
    """(numpy batch) of ``B`` prompts of ``S`` tokens, with the family's
    extra inputs (vision embeddings and M-RoPE positions, audio frames)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embed"] = (rng.standard_normal((B, 4, cfg.d_model))
                                 * 0.02).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
        batch["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[None], (3, B, S)))
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.encoder_dim)) * 0.1).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_a_given_cache(arch):
    changes = {"kv_block": 4} if arch != "mamba2-1.3b" else {}
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **changes)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    B, S, max_seq = 2, 6, 18
    batch = _inputs(tcfg, B, S, 3)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    own_logits, own = serve.prefill(tparams, tcfg, tbatch, max_seq)
    given = serve.init_cache(tcfg, B, max_seq, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, tbatch, max_seq,
                                  cache=given)
    assert torch.equal(logits, own_logits)
    assert set(cache) == set(own)
    for key in own:
        assert torch.equal(cache[key], own[key]), key
        assert cache[key] is given[key], key        # written in place

    jlogits, jcache = jax_serve.prefill(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache) == set(jcache)
    for key in jcache:
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)
