"""The CUDA lookup kernel's 32-way search, mirrored step by step in plain
ops (``ref.optimistic_lookup_search``), against the JAX package's Pallas
kernel in interpret mode and its searchsorted oracle.

The kernel cannot run on the CPU; its mirror takes the same pivot steps,
ballots and segment loads, so a wrong step shows here.  Everything is
integer: idx, found and iters must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.optimistic_lookup.kernel import \
    optimistic_lookup as jax_optimistic_lookup
from repro.kernels.optimistic_lookup.ref import \
    optimistic_lookup_ref as jax_lookup_oracle
from repro_torch.kernels.optimistic_lookup.ref import (
    lookup_indices_ref, optimistic_lookup_search)
from test_torch_kernels_cuda import LOOKUP_CASES, _lookup_case, _t


@pytest.mark.parametrize("kind,window,max_iters", LOOKUP_CASES)
def test_lookup_search_matches_jax(kind, window, max_iters):
    keys, queries = _lookup_case(kind, 11)
    jq, jk = jnp.asarray(queries), jnp.asarray(keys)
    want = [np.asarray(a) for a in jax_optimistic_lookup(
        jq, jk, window=window, max_iters=max_iters, interpret=True)]
    got = optimistic_lookup_search(_t(queries), _t(keys), window=window,
                                   max_iters=max_iters)
    for name, g, w in zip(("idx", "found", "iters"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    # The resolve entry: the rounds' answer, the JAX oracle's where they ran
    # out; equal to the plain version the card holds the kernel against.
    oidx, ofound = (np.asarray(a) for a in jax_lookup_oracle(jq, jk))
    unresolved = want[0] < 0
    ridx, rfound, riters = optimistic_lookup_search(
        _t(queries), _t(keys), window=window, max_iters=max_iters,
        resolve=True)
    np.testing.assert_array_equal(ridx.numpy(),
                                  np.where(unresolved, oidx, want[0]))
    np.testing.assert_array_equal(rfound.numpy(),
                                  np.where(unresolved, ofound, want[1]))
    np.testing.assert_array_equal(riters.numpy(), want[2])
    np.testing.assert_array_equal(rfound.numpy(), ofound)
    for g, w in zip((ridx, rfound), lookup_indices_ref(
            _t(queries), _t(keys), window=window, max_iters=max_iters)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
