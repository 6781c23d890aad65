"""The port's encoder-decoder family (whisper-large-v3's SMOKE config)
against the JAX package's, on the same numpy-seeded tokens and frame
embeddings, with the JAX package's parameters carried across
(``params_from_numpy``): init layout and parameter count, the encoder,
``forward``, and ``prefill`` then teacher-forced ``decode_step``s (the
port's self-attention through the ``tide_attention`` plain version, with a
``first_live`` watermark moved past a block boundary midway), at rtol/atol
2e-4 (fp32), every cache entry included (the KV-WAL arenas and the cross
K/V computed once at prefill).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import kvwal as jax_kvwal
from repro.models import serve as jax_serve
from repro.models import transformer as jax_T
from repro_torch.configs.registry import get_config
from repro_torch.core import kvwal
from repro_torch.models import serve, transformer as T
from repro_torch.models.convert import params_from_numpy

ARCH = "whisper-large-v3"
TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(**changes):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **changes)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.encoder_dim)
                                 ).astype(np.float32)
    return tokens, frames


@pytest.mark.parametrize("encoder_dim", [0, 48])
def test_init_params_matches_jax_layout(encoder_dim):
    """The SMOKE layout, and one with encoder states narrower than the
    model (``frontend_proj``, and cross K/V projections that read them)."""
    changes = dict(encoder_dim=encoder_dim) if encoder_dim else {}
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    ours = T.init_params(cfg, torch.Generator().manual_seed(0))
    theirs = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(ours) == shapes(theirs)
    assert ("frontend_proj" in ours) == bool(encoder_dim)
    assert sum(p.numel() for p in jax.tree.leaves(ours)) == \
        jax_T.param_count_exact(jcfg)


def test_angles_are_none():
    """Whisper has no RoPE: positions enter as sinusoidal embeddings."""
    cfg = get_config(ARCH, smoke=True)
    assert T._angles(cfg, torch.zeros((2, 3), dtype=torch.int32)) == \
        (None, None)


def test_sinusoidal_embedding_matches_jax():
    from repro.models.layers import sinusoidal_embedding as jax_sin
    from repro_torch.models.layers import sinusoidal_embedding
    pos = np.arange(1500, dtype=np.int32)[None]
    want = jax_sin(jnp.asarray(pos), 1280)
    got = sinusoidal_embedding(torch.from_numpy(pos), 1280)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-4)


def test_encoder_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    _, frames = _inputs(tcfg, 2, 1, 0)
    want = jax_T.encode(jparams, jcfg, jnp.asarray(frames))
    got = T.encode(tparams, tcfg, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    tokens, frames = _inputs(tcfg, 2, 12, 1)
    want, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                            frames=jnp.asarray(frames))
    got, aux = T.forward(tparams, tcfg, torch.from_numpy(tokens),
                         frames=torch.from_numpy(frames))
    assert got.shape == (2, 12, tcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax():
    """Prefill 5 tokens, then 9 teacher-forced decode steps; after the
    fourth, ``prune_below`` moves both rows' watermarks past a block
    boundary (4-slot blocks), which whisper's self-attention honours."""
    jcfg, tcfg, jparams, tparams = _pair(kv_block=4)
    B, PRE, SL = 2, 5, 14
    tokens, frames = _inputs(tcfg, B, SL, 2)
    jlogits, jcache = jax_serve.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :PRE]),
                        "frames": jnp.asarray(frames)}, max_seq=SL + 6)
    tlogits, tcache = serve.prefill(
        tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :PRE]),
                        "frames": torch.from_numpy(frames)}, SL + 6)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert set(tcache) == set(jcache) >= {"cross_k", "cross_v"}
    assert tuple(tcache["cross_k"].shape) == (
        tcfg.n_layers, B, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.hd)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)
    for t in range(PRE, SL):
        if t == PRE + 4:
            live = np.array([6, 4], np.int32)
            jcache = jax_kvwal.prune_below(jcache, jnp.asarray(live))
            tcache = kvwal.prune_below(tcache, torch.from_numpy(live))
            np.testing.assert_array_equal(tcache["first_live"].numpy(),
                                          [4, 4])
        jlogits, jcache = jax_serve.decode_step(jparams, jcfg, jcache,
                                                jnp.asarray(tokens[:, t]))
        tlogits, tcache = serve.decode_step(tparams, tcfg, tcache,
                                            torch.from_numpy(tokens[:, t]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"decode {t}")
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)


def test_decode_from_a_jax_cache():
    """A whisper cache written by the JAX package (arenas and cross K/V)
    decodes in the port."""
    from repro_torch.models.convert import cache_from_numpy
    jcfg, tcfg, jparams, tparams = _pair()
    tokens, frames = _inputs(tcfg, 2, 7, 3)
    _, jcache = jax_serve.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :6]),
                        "frames": jnp.asarray(frames)}, max_seq=16)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    want, _ = jax_serve.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(tokens[:, 6]))
    got, _ = serve.decode_step(tparams, tcfg, tcache,
                               torch.from_numpy(tokens[:, 6]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
