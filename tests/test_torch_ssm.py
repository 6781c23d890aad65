"""The port's Mamba-2 stack against the JAX package's.

On the CPU ``ops.ssd`` takes the plain version of kernel E; it is held
against the Pallas kernel ``ssd_scan_pallas`` run in interpret mode (through
the JAX package's ``ops.ssd``, which pads as the port's does) and against
the JAX model's ``ssd_scan``, at ``TestSsdScan``'s shapes and tolerance
(3e-4).  The Mamba-2 block, ``forward``, ``prefill`` and teacher-forced
``decode_step``s run on the JAX package's parameters, carried across as
numpy arrays, at 2e-4 (the tolerance of ``tests/test_models.py``).  The
CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.models import serve as jax_serve
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_T
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models import serve, ssm, transformer as T
from repro_torch.models.convert import (cache_from_numpy, cast_weights,
                                        params_from_numpy)
from test_torch_kernels_cuda import _ssd_case

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-1.3b"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("b,l,h,p,n,c", [
    (2, 64, 8, 16, 32, 16),
    (1, 128, 4, 64, 128, 32),     # production-like head/state dims
    (3, 48, 8, 16, 16, 16),
    (2, 40, 4, 16, 32, 16),       # padding path
    (2, 11, 4, 16, 32, 16),       # l < chunk: one chunk of l
])
def test_ssd_matches_pallas_and_jax(b, l, h, p, n, c):
    x, dt, A, Bm, Cm, _ = _ssd_case(l, b, l, h, p, n)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    pallas = jax_ssd(*jargs, chunk=c, interpret=True)
    oracle = jax_ssm.ssd_scan(*jargs, c)
    before = ssd_kernel.launches["ssd_scan"]
    got = ssd(*[torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], chunk=c)
    assert ssd_kernel.launches["ssd_scan"] == before   # the CPU: no launch
    assert got[0].shape == (b, l, h, p) and got[1].shape == (b, h, p, n)
    for want in (pallas, oracle):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                       atol=3e-4)


@pytest.mark.parametrize("l,c", [(64, 16), (40, 16)])
def test_ssd_with_initial_state_matches_jax(l, c):
    x, dt, A, Bm, Cm, s0 = _ssd_case(l + 1, 2, l, 8, 16, 32, init=True)
    want = jax_ssm.ssd_scan(*[jnp.asarray(a) for a in (x, dt, A, Bm, Cm)],
                            c, jnp.asarray(s0))
    got = ssd(*[torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], chunk=c,
              init_state=torch.from_numpy(s0))
    assert ssm.ssd_scan is not None         # re-exported plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4)


def _pair(**changes):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **changes)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_ssm_block_matches_jax():
    """One block over a 13-token prompt (two chunks of 8, padded), then one
    decode step from the states it leaves."""
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tp = T.layer(tparams["layers"], 0)["ssm"]
    jy, jst = jax_ssm.ssm_block(jp, jnp.asarray(x), jcfg)
    ty, tst = ssm.ssm_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    jy, jst = jax_ssm.ssm_block(jp, jnp.asarray(x1), jcfg, *jst, decode=True)
    ty, tst = ssm.ssm_block(tp, torch.from_numpy(x1), tcfg, *tst,
                            decode=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 21)).astype(np.int32)
    want, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = T.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert got.shape == (2, 21, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax():
    """Prefill 11 tokens (a chunk and a padded one), then 8 teacher-forced
    decode steps; every cache entry equal after prefill and at the end."""
    jcfg, tcfg, jparams, tparams = _pair()
    B, PRE, SL = 2, 11, 19
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
    for t in range(PRE, SL):
        jlogits, jcache = jax_serve.decode_step(jparams, jcfg, jcache,
                                                jnp.asarray(tokens[:, t]))
        tlogits, tcache = serve.decode_step(tparams, tcfg, tcache,
                                            torch.from_numpy(tokens[:, t]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"decode {t}")
    same_caches()


def test_decode_from_a_jax_cache():
    """A serving cache written by the JAX package decodes in the port."""
    jcfg, tcfg, jparams, tparams = _pair()
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 10)).astype(np.int32)
    _, jcache = jax_serve.prefill(jparams, jcfg,
                                  {"tokens": jnp.asarray(tokens[:, :9])},
                                  max_seq=16)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache),
                              device="cpu")
    want, _ = jax_serve.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(tokens[:, 9]))
    got, _ = serve.decode_step(tparams, tcfg, tcache,
                               torch.from_numpy(tokens[:, 9]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cast_weights_keeps_the_fp32_leaves():
    """With bf16 activations the matrices and conv weights are cast once to
    bf16; ``A_log``, ``dt_bias`` and the norm scales, which every use reads
    in fp32, stay bit for bit."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    params["layers"]["ssm"]["A_log"].uniform_(-1, 1)
    params["layers"]["ssm"]["dt_bias"].uniform_(-1, 1)
    params["layers"]["ssm"]["norm"].uniform_(0.5, 1.5)
    before = [(path, leaf.clone()) for path, leaf in _leaves(params)]
    cast = cast_weights(params, torch.bfloat16)
    kept = {"A_log", "dt_bias", "norm", "ln1", "final_norm"}
    for (path, a), (_, b) in zip(before, _leaves(cast)):
        if path[-1] in kept:
            assert b.dtype == torch.float32 and torch.equal(a, b), path
        else:
            assert b.dtype == torch.bfloat16, path


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "whisper-large-v3"])
def test_cast_weights_keeps_the_moe_mla_and_whisper_fp32_leaves(arch):
    """The MoE router (made in fp32, read in fp32: a rounded router changes
    the routing), MLA's ``q_a_norm`` / ``kv_a_norm``, whisper's ``ln_x`` /
    ``enc_norm`` and the MTP module's ``ln`` stay bit for bit; the rest is
    cast to bf16."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    for path, leaf in _leaves(params):
        if leaf.dtype == torch.float32 and path[-1] != "router":
            leaf.uniform_(0.5, 1.5)          # not only ones: rounding shows
    before = [(path, leaf.clone()) for path, leaf in _leaves(params)]
    cast = cast_weights(params, torch.bfloat16)
    kept = {"router", "q_a_norm", "kv_a_norm", "ln_x", "enc_norm", "ln",
            "ln1", "ln2", "final_norm"}
    seen = set()
    for (path, a), (_, b) in zip(before, _leaves(cast)):
        if path[-1] in kept:
            seen.add(path[-1])
            assert b.dtype == torch.float32 and torch.equal(a, b), path
        else:
            assert b.dtype == torch.bfloat16, path
    want = {"ln1", "ln2", "final_norm"} | {
        "qwen2-moe-a2.7b": {"router"},
        "deepseek-v3-671b": {"router", "q_a_norm", "kv_a_norm", "ln"},
        "whisper-large-v3": {"ln_x", "enc_norm"}}[arch]
    assert seen == want


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b"])
def test_cast_weights_casts_in_place(arch):
    """The cast happens in the caller's own containers (griffin's ``tail``
    list included), gives each leaf its copy under the rule (``FP32_KEYS``
    kept, the rest ``.to(bf16)``), and holds no reference to a replaced
    fp32 leaf, so the device frees it at once."""
    import weakref
    from repro_torch.models.convert import FP32_KEYS
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    want = [(path, leaf if path[-1] in FP32_KEYS else leaf.to(torch.bfloat16))
            for path, leaf in _leaves(params)]
    refs = {path: weakref.ref(leaf) for path, leaf in _leaves(params)}
    inner = params["tail" if "tail" in params else "layers"]
    got = cast_weights(params, torch.bfloat16)
    assert got is params
    assert got["tail" if "tail" in got else "layers"] is inner
    assert [p for p, _ in _leaves(got)] == [p for p, _ in want]
    for (path, a), (_, b) in zip(_leaves(got), want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    del want, a, b
    for path, ref in refs.items():
        if path[-1] not in FP32_KEYS:
            assert ref() is None, path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree
