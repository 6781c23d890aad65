"""The port's RecurrentGemma (Griffin) stack against the JAX package's.

The JAX package's parameters cross as numpy arrays, inputs come from numpy
seeds.  The RG-LRU's log-depth scan, the recurrent block, ``forward``,
windowed prefill and teacher-forced ``decode_step``s agree at rtol/atol 2e-4
(the tolerance of ``tests/test_models.py``).  Decode runs past the SMOKE
config's 16-slot window with 8-slot KV-WAL blocks, so the window masks
positions inside ``tide_attention`` (its plain version on the CPU) and
``first_live`` advances, as the JAX package advances it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import griffin as jax_griffin
from repro.models import serve as jax_serve
from repro.models import transformer as jax_T
from repro_torch.configs.registry import get_config
from repro_torch.models import griffin, serve, transformer as T
from repro_torch.models.convert import (cache_from_numpy, cast_weights,
                                        params_from_numpy)
from test_torch_ssm import _leaves

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "recurrentgemma-9b"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(**changes):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **changes)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("L", [1, 2, 7, 64, 100])
def test_linear_scan_matches_a_loop(L):
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, L, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, L, 3)).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(griffin.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-5, atol=1e-5)


def test_recurrent_block_matches_jax():
    """A 20-token prompt, then one decode step from the states it leaves,
    then a second prompt that starts from those states."""
    jcfg, tcfg, jparams, tparams = _pair()
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["blk0"]["rec"])
    tp = T.layer(tparams["groups"], 0)["blk0"]["rec"]
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)
          for n in (20, 1, 5)]
    jst = tst = (None, None)
    for x in xs:
        jy, jst = jax_griffin.recurrent_block(jp, jnp.asarray(x), jcfg, *jst)
        ty, tst = griffin.recurrent_block(tp, torch.from_numpy(x), tcfg,
                                          *tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for g, w in zip(tst, jst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_forward_matches_jax():
    """20 tokens: longer than the 16-slot window of local attention."""
    jcfg, tcfg, jparams, tparams = _pair()
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 20)).astype(np.int32)
    want, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = T.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert got.shape == (2, 20, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax():
    """Prefill 18 tokens (past the window), then 8 teacher-forced decode
    steps; first_live advances to block 1 (position 8) on the way, and every
    cache entry equals the JAX package's after prefill and at the end."""
    jcfg, tcfg, jparams, tparams = _pair()
    B, PRE, SL = 2, 18, 26
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab, (B, SL)).astype(np.int32)
    jlogits, jcache = jax_serve.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :PRE])}, max_seq=32)
    tlogits, tcache = serve.prefill(
        tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :PRE])},
        max_seq=32)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert set(tcache) == set(jcache)

    def same_caches():
        for key in jcache:
            assert tcache[key].shape == jcache[key].shape, key
            assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype))
            np.testing.assert_allclose(_np(tcache[key]),
                                       np.asarray(jcache[key]), **TOL,
                                       err_msg=key)
    same_caches()
    live = []
    for t in range(PRE, SL):
        jlogits, jcache = jax_serve.decode_step(jparams, jcfg, jcache,
                                                jnp.asarray(tokens[:, t]))
        tlogits, tcache = serve.decode_step(tparams, tcfg, tcache,
                                            torch.from_numpy(tokens[:, t]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"decode {t}")
        np.testing.assert_array_equal(tcache["first_live"].numpy(),
                                      np.asarray(jcache["first_live"]))
        live.append(int(tcache["first_live"][0]))
    assert live[0] == 0 and live[-1] == 8
    same_caches()


def test_decode_from_a_jax_cache():
    """A serving cache written by the JAX package decodes in the port."""
    jcfg, tcfg, jparams, tparams = _pair()
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 24)).astype(np.int32)
    _, jcache = jax_serve.prefill(jparams, jcfg,
                                  {"tokens": jnp.asarray(tokens[:, :23])},
                                  max_seq=32)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache),
                              device="cpu")
    want, jnext = jax_serve.decode_step(jparams, jcfg, jcache,
                                        jnp.asarray(tokens[:, 23]))
    got, tnext = serve.decode_step(tparams, tcfg, tcache,
                                   torch.from_numpy(tokens[:, 23]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tnext["first_live"].numpy(),
                                  np.asarray(jnext["first_live"]))


def test_cast_weights_keeps_the_fp32_leaves_and_descends_the_tail():
    """With bf16 activations, the RG-LRU's w_r, w_i, b_r, b_i and lam and
    the norm scales stay fp32 bit for bit, in the stacked groups and in the
    ``tail`` list alike; every other leaf is bf16."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert isinstance(params["tail"], list) and len(params["tail"]) == 2
    for rec in [params["groups"]["blk0"]["rec"], params["tail"][1]["rec"]]:
        for k in ("b_r", "b_i", "lam"):
            rec[k].uniform_(-1, 1)
    before = [(path, leaf.clone()) for path, leaf in _leaves(params)]
    cast = cast_weights(params, torch.bfloat16)
    assert isinstance(cast["tail"], list)
    kept = {"w_r", "w_i", "b_r", "b_i", "lam", "ln1", "ln2", "final_norm"}
    leaves = list(zip(before, _leaves(cast)))
    assert any(path[0] == "tail" and path[-1] == "w_r"
               for (path, _), _ in leaves)
    for (path, a), (_, b) in leaves:
        if path[-1] in kept:
            assert b.dtype == torch.float32 and torch.equal(a, b), path
        else:
            assert b.dtype == torch.bfloat16, path
