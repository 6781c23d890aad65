"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same numpy-seeded inputs.

The JAX block returns only (y, aux).  Its routing is read off the two
products that carry it: the dispatch einsum's first operand is the
dispatch mask, and the combine einsum's first operand is dispatch × gates,
whose sum over the capacity slots is the gates.  A recording stand-in for
the module's ``jnp`` captures them; the JAX package itself is unchanged.

Routing is discrete: a top-k near-tie that rounding resolves differently
in the two packages would change the experts.  So every case asserts that
each token's k-th and (k+1)-th router probabilities differ by more than
1e-5, and then the dispatch mask must be equal exactly.  The gates agree
to the last bits of fp32 (rtol/atol 1e-6: the router's product and softmax
are summed in another order by XLA and by PyTorch, so a gate may differ by
an ulp or two); the outputs and the aux loss agree at rtol/atol 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
GATE_TOL = dict(rtol=1e-6, atol=1e-6)
MARGIN = 1e-5
MOE_ARCHS = [a for a in ARCH_IDS if get_config(a).moe is not None]


class _Recorder:
    """``jax.numpy`` with ``einsum`` recording its operands."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.calls.append((spec, ops))
        return jnp.einsum(spec, *ops, **kw)


def _params(arch, seed=3, **moe_changes):
    jcfg = jax_get_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    jm = dataclasses.replace(jcfg.moe, **moe_changes)
    tm = dataclasses.replace(tcfg.moe, **moe_changes)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg.d_model, jm,
                          jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    return jm, tm, jp


def _run_both(jm, tm, jp, x, monkeypatch):
    """→ (JAX (y, aux, dispatch, gates), port (y, aux, dispatch, gates,
    probs)), all numpy."""
    rec = _Recorder()
    monkeypatch.setattr(jax_moe, "jnp", rec)
    jy, jaux = jax_moe.moe_block({k: jnp.asarray(v) for k, v in jp.items()},
                                 jnp.asarray(x), jm)
    monkeypatch.undo()
    (s0, (jdispatch, _)), (s1, (jcombine, _)) = rec.calls[0], rec.calls[-1]
    assert (s0, s1) == ("gsec,gsd->gecd", "gsec,gecd->gsd")
    tp = params_from_numpy(jp, device="cpu")
    tx = torch.from_numpy(x)
    ty, taux = moe.moe_block(tp, tx, tm)
    dispatch, gates, probs, _ = moe.moe_route(
        tp["router"], moe.group_tokens(tx, tm), tm)
    return ((np.asarray(jy), float(jaux), np.asarray(jdispatch),
             np.asarray(jcombine).sum(-1)),
            (ty.numpy(), float(taux), dispatch.numpy(), gates.numpy(),
             probs.numpy()))


def _margins(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[..., k - 1] - top[..., k]


def _check(jm, tm, jp, x, monkeypatch):
    (jy, jaux, jd, jg), (ty, taux, td, tg, probs) = _run_both(
        jm, tm, jp, x, monkeypatch)
    assert _margins(probs, tm.top_k).min() > MARGIN
    assert td.shape == jd.shape == (*probs.shape, moe.moe_capacity(tm))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tg, jg, **GATE_TOL)
    assert ((tg > 0) == (jg > 0)).all()
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)
    return td, tg


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_moe_capacity_matches_jax(arch, smoke):
    tm = get_config(arch, smoke).moe
    assert moe.moe_capacity(tm) == jax_moe.moe_capacity(
        jax_get_config(arch, smoke).moe)
    assert moe.moe_capacity(tm) % 4 == 0 and moe.moe_capacity(tm) >= 4


def test_moe_capacity_of_the_full_configs():
    """C = ceil(512·k·1.25/E) rounded up to a multiple of 4: 43 → 44 for
    Qwen2-MoE (60 experts, top-4), 20 for DeepSeek-V3 (256, top-8)."""
    assert moe.moe_capacity(get_config("qwen2-moe-a2.7b").moe) == 44
    assert moe.moe_capacity(get_config("deepseek-v3-671b").moe) == 20


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_block_matches_jax(arch, norm_topk, monkeypatch):
    """One group of 32 tokens (2 × 16), shared experts on."""
    jm, tm, jp = _params(arch, router_norm_topk=norm_topk)
    x = np.random.default_rng(11).standard_normal((2, 16, 64)).astype(
        np.float32)
    td, tg = _check(jm, tm, jp, x, monkeypatch)
    assert 0 < td.sum() <= 32 * tm.top_k
    if not norm_topk:
        assert tg.sum(-1).max() < 1.0


def test_moe_block_two_groups_match_jax(monkeypatch):
    """64 tokens at group 32: two groups, each with its own capacity."""
    jm, tm, jp = _params("qwen2-moe-a2.7b", seed=5)
    x = np.random.default_rng(12).standard_normal((2, 32, 64)).astype(
        np.float32)
    td, _ = _check(jm, tm, jp, x, monkeypatch)
    assert td.shape[0] == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_drops_tokens_at_capacity_like_jax(arch, monkeypatch):
    """A router biased toward expert 0 sends all 32 tokens of the group
    there; its capacity is 20, so the last 12 in token order are dropped
    for it (and may be dropped by a full second expert as well)."""
    jm, tm, jp = _params(arch, seed=4)
    jp["router"] = jp["router"].copy()
    jp["router"][:, 0] += 0.02
    x = (np.random.default_rng(13).standard_normal((2, 16, 64)) + 1.0
         ).astype(np.float32)
    td, tg = _check(jm, tm, jp, x, monkeypatch)
    C = moe.moe_capacity(tm)
    assert C == 20
    to_zero = td[0, :, 0].sum(-1)                 # (g,) 1 where dispatched
    np.testing.assert_array_equal(to_zero, [1] * C + [0] * (32 - C))
    assert (tg[0, C:, 0] == 0).all() and (tg[0, :C, 0] > 0).all()
    assert td.sum() <= 32 * tm.top_k - (32 - C)


@pytest.mark.parametrize("B,S", [(1, 40), (3, 16), (1, 33)])
def test_group_reshape_raises_where_jax_raises(B, S):
    """Above the group size a token count must be a multiple of it: 40,
    48 and 33 tokens at group 32 fail in the JAX package's reshape, and
    the port raises ``ValueError`` there too (neither pads)."""
    jm, tm, jp = _params("qwen2-moe-a2.7b")
    x = np.zeros((B, S, 64), np.float32)
    with pytest.raises(TypeError):
        jax_moe.moe_block({k: jnp.asarray(v) for k, v in jp.items()},
                          jnp.asarray(x), jm)
    with pytest.raises(ValueError, match="do not split into MoE groups"):
        moe.moe_block(params_from_numpy(jp, device="cpu"),
                      torch.from_numpy(x), tm)


@pytest.mark.parametrize("B,S", [(1, 7), (2, 32), (4, 24)])
def test_group_sizes_that_both_take(B, S, monkeypatch):
    """Below the group size one group holds every token; 64 and 96 tokens
    split into whole groups of 32."""
    jm, tm, jp = _params("deepseek-v3-671b", seed=6)
    x = np.random.default_rng(B * S).standard_normal((B, S, 64)).astype(
        np.float32)
    td, _ = _check(jm, tm, jp, x, monkeypatch)
    T = B * S
    assert td.shape[:2] == ((1, T) if T <= 32 else (T // 32, 32))


def test_router_and_experts_layout_matches_jax():
    """``init_moe``: the router is fp32 whatever the parameter dtype, the
    experts stack on a leading axis, the shared experts are one MLP of
    width n_shared · ff."""
    tm = get_config("qwen2-moe-a2.7b", smoke=True).moe
    gen = torch.Generator().manual_seed(0)
    ours = moe.init_moe(gen, 64, tm, torch.bfloat16, n=(3,))
    theirs = jax.eval_shape(lambda k: jax_moe.init_moe(
        k, 64, jax_get_config("qwen2-moe-a2.7b", smoke=True).moe,
        jnp.bfloat16), jax.random.PRNGKey(0))
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == (3, *v.shape), k
        assert str(ours[k].dtype).split(".")[1] == str(v.dtype), k
    assert ours["router"].dtype == torch.float32
    assert ours["ws_gate"].shape[-1] == tm.n_shared * tm.shared_d_ff
