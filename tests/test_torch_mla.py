"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
``layers.attention``'s ``scale`` against the JAX package's on the same
numpy-seeded inputs, at DeepSeek-V3's SMOKE widths (4 heads, q rank 32,
latent 16, nope 16 + rope 8, v 16), fp32, at rtol/atol 2e-4 (the
tolerance of ``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro_torch.configs.registry import get_config
from repro_torch.models import layers, mla
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "deepseek-v3-671b"


def _setup(seed=0):
    jcfg, tcfg = jax_get_config(ARCH, smoke=True), get_config(ARCH,
                                                              smoke=True)
    jp = jax.tree.map(np.asarray, jax_mla.init_mla(
        jax.random.PRNGKey(seed), jcfg, jnp.float32))
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu")


def _angles(cfg, positions):
    rope = cfg.mla.qk_rope_head_dim
    jc, js = jax_layers.rope_angles(jnp.asarray(positions), rope,
                                    cfg.rope_theta)
    tc, ts = layers.rope_angles(torch.from_numpy(positions), rope,
                                cfg.rope_theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    return (jc, js), (tc, ts)


def _x(rng, B, S, d):
    return rng.standard_normal((B, S, d)).astype(np.float32)


def test_init_mla_layout_matches_jax():
    jcfg, tcfg, jp, _ = _setup()
    ours = mla.init_mla(torch.Generator().manual_seed(0), tcfg,
                        torch.float32, n=(2,))
    assert set(ours) == set(jp)
    for k, v in jp.items():
        assert tuple(ours[k].shape) == (2, *v.shape), k
    assert (ours["q_a_norm"] == 1).all() and (ours["kv_a_norm"] == 1).all()


def test_compress_kv_matches_jax():
    jcfg, tcfg, jp, tp = _setup(1)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 8, tcfg.d_model)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8)).copy()
    (jc, js), (tc, ts) = _angles(tcfg, pos)
    jkv, jrope = jax_mla.compress_kv(jp, jnp.asarray(x), jcfg, jc, js)
    tkv, trope = mla.compress_kv(tp, torch.from_numpy(x), tcfg, tc, ts)
    m = tcfg.mla
    assert tuple(tkv.shape) == (2, 8, m.kv_lora_rank)
    assert tuple(trope.shape) == (2, 8, m.qk_rope_head_dim)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), **TOL)
    np.testing.assert_allclose(trope.numpy(), np.asarray(jrope), **TOL)


@pytest.mark.parametrize("S", [1, 8, 13])
def test_mla_train_matches_jax(S):
    jcfg, tcfg, jp, tp = _setup(2)
    rng = np.random.default_rng(S)
    x = _x(rng, 2, S, tcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S)).copy()
    (jc, js), (tc, ts) = _angles(tcfg, pos)
    jo, (jkv, jrope) = jax_mla.mla_train(jp, jnp.asarray(x), jcfg, jc, js)
    to, (tkv, trope) = mla.mla_train(tp, torch.from_numpy(x), tcfg, tc, ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), **TOL)
    np.testing.assert_allclose(trope.numpy(), np.asarray(jrope), **TOL)


def test_mla_decode_matches_jax():
    """Absorbed decode over 24 cached positions, each row masked at its own
    length (one row at length 1)."""
    jcfg, tcfg, jp, tp = _setup(3)
    m = tcfg.mla
    rng = np.random.default_rng(3)
    B, T = 3, 24
    x = _x(rng, B, 1, tcfg.d_model)
    c = rng.standard_normal((B, T, m.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((B, T, m.qk_rope_head_dim)).astype(np.float32)
    kv_len = np.array([24, 1, 11], np.int32)
    (jc, js), (tc, ts) = _angles(tcfg, (kv_len - 1)[:, None].copy())
    want = jax_mla.mla_decode(jp, jnp.asarray(x), jcfg, jc, js,
                              jnp.asarray(c), jnp.asarray(r),
                              jnp.asarray(kv_len))
    got = mla.mla_decode(tp, torch.from_numpy(x), tcfg, tc, ts,
                         torch.from_numpy(c), torch.from_numpy(r),
                         torch.from_numpy(kv_len))
    assert tuple(got.shape) == (B, 1, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_equals_the_expanded_form():
    """The absorbed decode of the last position equals ``mla_train`` over
    the whole sequence at that position: the latents cached by
    ``compress_kv`` carry everything the expanded heads need."""
    _, tcfg, _, tp = _setup(4)
    rng = np.random.default_rng(4)
    B, S = 2, 9
    x = torch.from_numpy(_x(rng, B, S, tcfg.d_model))
    pos = torch.arange(S)[None].expand(B, S)
    cos, sin = layers.rope_angles(pos, tcfg.mla.qk_rope_head_dim,
                                  tcfg.rope_theta)
    full, (c, r) = mla.mla_train(tp, x, tcfg, cos, sin)
    last = mla.mla_decode(tp, x[:, -1:], tcfg, cos[:, -1:], sin[:, -1:], c,
                          r, torch.full((B,), S))
    torch.testing.assert_close(last, full[:, -1:], **TOL)


@pytest.mark.parametrize("causal,scale,chunk_q", [
    (True, 0.2, 0), (True, 0.15, 4), (False, 1.3, 0)])
def test_attention_scale_matches_jax(causal, scale, chunk_q):
    """``scale`` replaces hd^-½ (MLA passes (nope + rope)^-½, here with a
    value head narrower than the key head, as MLA's 16 under 24)."""
    rng = np.random.default_rng(int(scale * 100))
    q = rng.standard_normal((2, 8, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 8, 4, 24)).astype(np.float32)
    v = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    want = jax_layers.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, scale=scale,
                                chunk_q=chunk_q)
    got = layers.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, scale=scale,
                           chunk_q=chunk_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    default = layers.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               chunk_q=chunk_q)
    assert not torch.allclose(got, default)
