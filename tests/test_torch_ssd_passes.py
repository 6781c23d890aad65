"""Kernel E's three passes, mirrored in plain ops, against the JAX package.

``ref.ssd_scan_passes`` computes what the CUDA kernel ``csrc/ssd_scan.cu``
computes, pass by pass (chunk states, state passing, chunk output).  In
fp32 it is held at 1e-5 against the Pallas kernel ``ssd_scan_pallas`` in
interpret mode and the JAX model's ``ssd_scan`` (at Mamba-2's chunk of 256,
against the port's plain version; see that test).  With ``split=True`` it
rounds every operand as the kernel does (bf16 inputs exact, each computed
fp32 operand as a hi and a lo bf16 part; fp32 inputs and operands as three
parts), so the split's precision is settled here: the bf16 run is held to
the card checks' own rules (state within 3e-4 of the fp32 run; y's mean
error at most 1.25 times the plain version's), the fp32 run at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ssd_scan.ref import (bf16_parts, ssd_chunk_states,
                                              ssd_scan, ssd_scan_passes,
                                              ssd_state_passing)
from test_torch_kernels_cuda import _ssd_case

SMALL = [
    # b, l, h, p, n, c, init
    (2, 64, 8, 16, 32, 16, False),    # TestSsdScan's shapes
    (2, 40, 4, 16, 32, 16, False),    # ragged: the padding path
    (2, 11, 4, 16, 32, 16, False),    # l < chunk: one chunk of l
    (2, 64, 8, 16, 32, 16, True),     # an initial state
    (2, 48, 6, 16, 16, 16, True),     # h = 6, no block of 4 heads
]
MAMBA2 = (1, 300, 3, 64, 128, 256, False)   # Mamba-2's p, n, chunk; ragged
CASES = SMALL + [MAMBA2]


def _torch(case):
    return [None if a is None else torch.from_numpy(a) for a in case]


@pytest.mark.parametrize("b,l,h,p,n,c,init", SMALL)
def test_passes_match_pallas_and_jax(b, l, h, p, n, c, init):
    case = _ssd_case(l * 3 + h, b, l, h, p, n, init)
    x, dt, A, Bm, Cm, s0 = _torch(case)
    got = ssd_scan_passes(x, dt, A, Bm, Cm, chunk=c, init_state=s0)
    assert got[0].shape == (b, l, h, p) and got[1].shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in case[:5]]
    wants = [jax_ssm.ssd_scan(*jargs, c, None if s0 is None
                              else jnp.asarray(case[5]))]
    if s0 is None:               # the Pallas kernel starts from zeros
        wants.append(jax_ssd(*jargs, chunk=c, interpret=True))
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_passes_match_plain_at_the_mamba2_chunk():
    """At chunk 256 the cumulative sums reach ~-180, so every fp32 version
    rounds its decays by ~1e-5 relative: against a float64 recurrence the
    port's plain version and the JAX functions are all ~1e-4 off, and the
    JAX functions (another summation order) 2.5e-4 from the port's.  The
    passes share the plain version's sums, so they are held to it at 1e-5,
    and to the JAX ones at the 3e-4 of ``tests/test_torch_ssm.py``."""
    b, l, h, p, n, c, _ = MAMBA2
    case = _ssd_case(l * 3 + h, b, l, h, p, n)
    x, dt, A, Bm, Cm, _ = _torch(case)
    got = ssd_scan_passes(x, dt, A, Bm, Cm, chunk=c)
    for g, w in zip(got, ssd_scan(x, dt, A, Bm, Cm, chunk=c)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    jargs = [jnp.asarray(a) for a in case[:5]]
    for want in (jax_ssm.ssd_scan(*jargs, c),
                 jax_ssd(*jargs, chunk=c, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                       atol=3e-4)


def test_passes_compose_over_a_split_sequence():
    """The final state of the first half, fed as the initial state of the
    second, gives the whole sequence's y and final state: what the state
    passing carries between chunks is the whole state."""
    x, dt, A, Bm, Cm, s0 = _torch(_ssd_case(5, 2, 96, 4, 16, 32, True))
    y, st = ssd_scan_passes(x, dt, A, Bm, Cm, chunk=16, init_state=s0)
    y1, s1 = ssd_scan_passes(x[:, :48], dt[:, :48], A, Bm[:, :48],
                             Cm[:, :48], chunk=16, init_state=s0)
    y2, s2 = ssd_scan_passes(x[:, 48:], dt[:, 48:], A, Bm[:, 48:],
                             Cm[:, 48:], chunk=16, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s2, st, rtol=1e-5, atol=1e-5)


def test_state_passing_is_the_chunk_recurrence():
    """prev_0 is the initial state, prev_{z+1} = exp(cs_last_z) prev_z +
    S_z, and the final state is one step past the last chunk."""
    x, dt, A, Bm, _, s0 = _torch(_ssd_case(9, 2, 64, 4, 16, 32, True))
    states, cs = ssd_chunk_states(x, dt, A, Bm, chunk=16)
    assert states.shape == (2, 4, 4, 16, 32) and cs.shape == (2, 4, 16, 4)
    prev, final = ssd_state_passing(states, cs[:, :, -1], s0)
    torch.testing.assert_close(prev[:, 0], s0)
    for z in range(4):
        nxt = prev[:, z + 1] if z < 3 else final
        torch.testing.assert_close(
            nxt, torch.exp(cs[:, z, -1])[..., None, None] * prev[:, z]
            + states[:, z], rtol=1e-6, atol=1e-6)


def test_bf16_parts_hold_the_value():
    """Two parts keep ~16 bits of an fp32 value and three ~24; each part is
    a bf16 value."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 10
    for k, rel in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -23)):
        parts = bf16_parts(v, k)
        assert all(torch.equal(q, q.bfloat16().float()) for q in parts)
        assert float(((sum(parts) - v).abs() / v.abs()).max()) <= rel


@pytest.mark.parametrize("b,l,h,p,n,c,init", CASES)
def test_split_bf16_holds_the_card_rules(b, l, h, p, n, c, init):
    """bf16 inputs through the kernel's split products: y's mean error
    against the fp32 run at most 1.25 times the plain version's (which
    rounds C·Bᵀ to bf16), and the fp32 state within 3e-4 of the fp32
    run's, as ``test_ssd_scan_kernel_on_card`` holds the kernel."""
    x, dt, A, Bm, Cm, s0 = _torch(_ssd_case(l * 5 + h, b, l, h, p, n, init))
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    yk, sk = ssd_scan_passes(xb, dt, A, Bb, Cb, chunk=c, init_state=s0,
                             split=True)
    yp, _ = ssd_scan(xb, dt, A, Bb, Cb, chunk=c, init_state=s0)
    y32, s32 = ssd_scan(xb.float(), dt, A, Bb.float(), Cb.float(), chunk=c,
                        init_state=s0)
    assert yk.dtype == torch.bfloat16 and torch.isfinite(yk.float()).all()
    err = (yk.float() - y32).abs().mean()
    assert err <= 1.25 * (yp.float() - y32).abs().mean(), err
    torch.testing.assert_close(sk, s32, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("b,l,h,p,n,c,init", CASES)
def test_split_fp32_keeps_fp32_accuracy(b, l, h, p, n, c, init):
    """fp32 inputs as three bf16 parts, and the six products of rank sum at
    most 2, stay within 1e-5 of the plain fp32 version."""
    x, dt, A, Bm, Cm, s0 = _torch(_ssd_case(l * 7 + h, b, l, h, p, n, init))
    got = ssd_scan_passes(x, dt, A, Bm, Cm, chunk=c, init_state=s0,
                          split=True)
    want = ssd_scan(x, dt, A, Bm, Cm, chunk=c, init_state=s0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
