"""The port's dense and moe model stacks (GQA and MLA) and serving engine
against the JAX package's.

The JAX package's parameters cross as numpy arrays (``params_from_numpy``),
so both stacks run the same weights; token streams come from numpy seeds.
``forward``, ``prefill`` and teacher-forced ``decode_step``s — the port's
through the ``tide_attention`` plain version, the JAX package's through a
gather and dense attention — agree at rtol/atol 2e-4, the tolerance of
``tests/test_models.py``.  The engines agree token for token under greedy
decoding (JAX and torch random generators differ, so temperature sampling is
not compared); for the moe configs a seed counts only if every routing
decision is clear of rounding too (each token's k-th and (k+1)-th router
probabilities more than 1e-5 apart, asserted).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import kvwal as jax_kvwal
from repro.models import serve as jax_serve
from repro.models import transformer as jax_T
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import kvwal
from repro_torch.models import moe, serve, transformer as T
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "qwen3-0.6b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
         "deepseek-v3-671b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(arch, **changes):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **changes)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_configs_match_jax():
    from repro.configs.registry import ARCH_IDS as jax_ids
    assert ARCH_IDS == jax_ids
    for arch in ARCH_IDS:
        for smoke in (False, True):
            j, t = jax_get_config(arch, smoke), get_config(arch, smoke)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert t.param_count() == j.param_count()
            assert t.adtype == getattr(torch, j.dtype)
            assert t.pdtype == getattr(torch, j.param_dtype)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-0.6b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b"])
def test_init_params_matches_jax_layout(arch):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    ours = T.init_params(cfg, gen)
    theirs = jax_T.init_params(jax_get_config(arch, smoke=True),
                               jax.random.PRNGKey(0))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(ours) == shapes(theirs)
    assert sum(p.numel() for p in jax.tree.leaves(ours)) == \
        jax_T.param_count_exact(jax_get_config(arch, smoke=True))
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(ours),
                                                 jax.tree.leaves(again)))


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embed"] = (rng.standard_normal((B, 4, cfg.d_model))
                                 * 0.02).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
        extra["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[None], (3, B, S)))
    return tokens, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    tokens, extra = _inputs(tcfg, 2, 16, 1)
    want, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                            **{k: jnp.asarray(v) for k, v in extra.items()})
    got, _ = T.forward(tparams, tcfg, torch.from_numpy(tokens),
                       **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.shape == (2, 16, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 6 tokens, then 8 teacher-forced decode steps; after the
    fourth, ``prune_below`` moves both sequences' watermarks past a block
    boundary (4-slot blocks here, so that pruning bites at this length)."""
    jcfg, tcfg, jparams, tparams = _pair(arch, kv_block=4)
    B, PRE, SL = 2, 6, 14
    tokens, extra = _inputs(tcfg, B, SL, 2)
    jbatch = {"tokens": jnp.asarray(tokens[:, :PRE])}
    tbatch = {"tokens": torch.from_numpy(tokens[:, :PRE])}
    if "vision_embed" in extra:
        for b, f in ((jbatch, jnp.asarray), (tbatch, torch.from_numpy)):
            b["vision_embed"] = f(extra["vision_embed"])
            b["mrope_positions"] = f(np.ascontiguousarray(
                extra["mrope_positions"][:, :, :PRE]))
    jlogits, jcache = jax_serve.prefill(jparams, jcfg, jbatch, max_seq=SL + 10)
    tlogits, tcache = serve.prefill(tparams, tcfg, tbatch, max_seq=SL + 10)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]),
                                   **TOL, err_msg=key)
    for t in range(PRE, SL):
        if t == PRE + 4:
            live = np.array([9, 5], np.int32)
            jcache = jax_kvwal.prune_below(jcache, jnp.asarray(live))
            tcache = kvwal.prune_below(tcache, torch.from_numpy(live))
            np.testing.assert_array_equal(tcache["first_live"].numpy(), [8, 4])
        mrope = extra.get("mrope_positions")
        mrope = None if mrope is None else np.ascontiguousarray(
            mrope[:, :, t:t + 1])
        jlogits, jcache = jax_serve.decode_step(
            jparams, jcfg, jcache, jnp.asarray(tokens[:, t]),
            mrope_positions=None if mrope is None else jnp.asarray(mrope))
        tlogits, tcache = serve.decode_step(
            tparams, tcfg, tcache, torch.from_numpy(tokens[:, t]),
            mrope_positions=None if mrope is None else torch.from_numpy(mrope))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"{arch} decode {t}")
    for key in jcache:
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]),
                                   **TOL, err_msg=key)


def test_decode_from_a_jax_cache():
    """A serving cache written by the JAX package decodes in the port."""
    jcfg, tcfg, jparams, tparams = _pair("llama3-8b")
    tokens, _ = _inputs(tcfg, 2, 9, 3)
    _, jcache = jax_serve.prefill(jparams, jcfg,
                                  {"tokens": jnp.asarray(tokens[:, :8])},
                                  max_seq=32)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache),
                              device="cpu")
    want, _ = jax_serve.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(tokens[:, 8]))
    got, _ = serve.decode_step(tparams, tcfg, tcache,
                               torch.from_numpy(tokens[:, 8]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,seed", [("llama3-8b", 3), ("qwen3-0.6b", 0),
                                       ("qwen2-moe-a2.7b", 3),
                                       ("deepseek-v3-671b", 2)])
def test_engine_greedy_matches_jax(arch, seed, monkeypatch):
    """Six greedy requests of different prompt and output lengths over three
    slots.  Greedy parity needs every argmax to be clear of rounding: the
    port's engine records each active row's top-2 logit gap, and these
    seeds give gaps above 1e-3 at every step (asserted below).  A moe
    model's routing must be clear of rounding too: every MoE call records
    the smallest gap between a token's k-th and (k+1)-th router
    probability, which must exceed 1e-5."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    margins = []
    real_moe = T.moe_block

    def moe_block(params, x, cfg, dispatch_axes=None):
        probs = moe.moe_route(params["router"], moe.group_tokens(x, cfg),
                              cfg)[2]
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        margins.append((top[..., -2] - top[..., -1]).min().item())
        return real_moe(params, x, cfg, dispatch_axes)

    monkeypatch.setattr(T, "moe_block", moe_block)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (3, 9, 1, 17, 5, 12)]
    budgets = [4, 7, 2, 5, 9, 3]
    jeng = JaxServingEngine(jcfg, jparams, batch_slots=3, max_seq=48)
    teng = ServingEngine(tcfg, tparams, batch_slots=3, max_seq=48,
                         device="cpu")
    gaps = []
    real_decode, real_prefill = serve.decode_step, serve.prefill

    def gap(logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]).min().item()

    def decode_step(params, cfg, cache, tokens):
        logits, cache = real_decode(params, cfg, cache, tokens)
        gaps.append(gap(logits[list(teng.active)]))
        return logits, cache

    def prefill(params, cfg, batch, max_seq):
        logits, cache = real_prefill(params, cfg, batch, max_seq)
        gaps.append(gap(logits))
        return logits, cache

    monkeypatch.setattr(serve, "decode_step", decode_step)
    monkeypatch.setattr(serve, "prefill", prefill)
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    treqs = [teng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    jdone = jeng.run_until_drained()
    tdone = teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert all(r.done and len(r.out_tokens) == n
               for r, n in zip(treqs, budgets))
    assert teng.segments_recycled == jeng.segments_recycled == sum(
        -(-(len(p) + n - 1) // tcfg.kv_block) for p, n in zip(prompts, budgets))
    assert teng.prefills == 6 and teng.decode_steps > 0
    assert min(gaps) > 1e-3, min(gaps)
    if tcfg.moe is not None:
        assert len(margins) == tcfg.n_layers * (teng.prefills
                                                + teng.decode_steps)
        assert min(margins) > 1e-5, min(margins)


def test_engine_temperature_sampling_follows_its_seed():
    _, tcfg, _, tparams = _pair("qwen3-0.6b")

    def run(seed):
        eng = ServingEngine(tcfg, tparams, batch_slots=2, max_seq=32,
                            seed=seed, device="cpu")
        reqs = [eng.submit([1, 2, 3], max_new_tokens=6, temperature=1.5)
                for _ in range(3)]
        eng.run_until_drained()
        return [r.out_tokens for r in reqs]

    first = run(3)
    assert run(3) == first
    assert all(0 <= t < tcfg.vocab for toks in first for t in toks)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_engine_refuses_other_families(arch):
    """The engine splices KV-WAL arenas only, as the JAX engine does: it
    serves dense, vlm and moe, and refuses the ssm, griffin and encdec
    families, which the model stack runs through ``models/serve.py``."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError,
                       match=f"KV-WAL families only.*dense, vlm, moe.*not "
                             f"this {cfg.family} model"):
        ServingEngine(cfg, {}, device="cpu")


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)


def test_launcher_serves_on_the_cpu():
    res = _launch("--arch", "llama3-8b", "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--max-seq", "48",
                  "--max-new-tokens", "4")
    assert res.returncode == 0, res.stderr
    assert "[serve] llama3-8b on cpu: 3 requests, 12 tokens" in res.stdout
    refused = _launch("--arch", "mamba2-1.3b", "--smoke", "--device", "cpu")
    assert refused.returncode != 0
    assert "KV-WAL families (dense, vlm, moe), not ssm" in refused.stderr


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_launcher_serves_moe_on_the_cpu(arch):
    res = _launch("--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--max-seq", "32",
                  "--max-new-tokens", "3")
    assert res.returncode == 0, res.stderr
    assert f"[serve] {arch} on cpu: 3 requests, 9 tokens" in res.stdout


@pytest.mark.parametrize("causal,chunk_q", [
    (True, 4), (True, 0), (False, 8), (False, 0)])
def test_attention_matches_jax(causal, chunk_q):
    """Prefill attention with GQA, causal or not, query-chunked or not."""
    from repro.models.layers import attention as jax_attention
    from repro_torch.models.layers import attention
    rng = np.random.default_rng(chunk_q + causal)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, chunk_q=chunk_q)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal, chunk_q=chunk_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
