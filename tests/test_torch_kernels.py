"""The port's Bloom-probe and optimistic-lookup kernels against the JAX
package's.

On the CPU the port's ops take the kernels' plain PyTorch versions; they are
held bit for bit against the Pallas kernels run in interpret mode, against
the JAX package's ``ref.py`` oracles and ops wrappers.  Everything is
integer, so there is no tolerance.  The CUDA kernels themselves are held
against the plain versions in ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bloom_check import ops as jax_bloom_ops
from repro.kernels.bloom_check.kernel import bloom_check as jax_bloom_check
from repro.kernels.bloom_check.kernel import \
    bloom_check_ragged as jax_bloom_check_ragged
from repro.kernels.bloom_check.ref import (bloom_check_ragged_ref as
                                           jax_bloom_check_ragged_ref)
from repro.kernels.bloom_check.ref import bloom_check_ref as jax_bloom_check_ref
from repro.kernels.optimistic_lookup import ops as jax_lookup_ops
from repro.kernels.optimistic_lookup.kernel import \
    optimistic_lookup as jax_optimistic_lookup
from repro.kernels.optimistic_lookup.ref import \
    optimistic_lookup_ref as jax_lookup_oracle
from repro_torch.kernels.bloom_check import kernel as bloom_kernel
from repro_torch.kernels.bloom_check import ops as bloom_ops
from repro_torch.kernels.bloom_check.ref import (bloom_check_ragged_ref,
                                                 bloom_check_ref)
from repro_torch.kernels.optimistic_lookup import kernel as lookup_kernel
from repro_torch.kernels.optimistic_lookup import ops as lookup_ops
from repro_torch.kernels.optimistic_lookup.ref import (optimistic_lookup_ref,
                                                       searchsorted_oracle)
from test_torch_kernels_cuda import (_bloom_bits, _hashes, _lookup_case,
                                     _ragged_case, _t, _wraps)


# ---------------------------------------------------------------- kernel A

@pytest.mark.parametrize("nwords,nbits,nadd,k", [
    (64, None, 20, 7),
    (256, None, 100, 7),
    (1024, None, 500, 5),
    (32, 1000, 40, 7),          # modulus not a power of two: wrap shows
    (100, 3171, 150, 7),
])
def test_bloom_check_matches_jax(nwords, nbits, nadd, k):
    rng = np.random.default_rng(nwords + nadd)
    mod = nbits or nwords * 32
    h1a, h2a = _hashes(rng, nadd)
    bits = _bloom_bits(h1a, h2a, mod, nwords, k)
    h1m, h2m = _hashes(rng, 200)
    h1 = np.concatenate([h1a, h1m, np.uint32([0xFFFFFFFF, 0xFFFFFFF0])])
    h2 = np.concatenate([h2a, h2m, np.uint32([0xFFFFFFFF, 0x80000001])])
    if nbits is not None:
        assert _wraps(h1, h2, mod, k)
    want = np.asarray(jax_bloom_check(jnp.asarray(h1), jnp.asarray(h2),
                                      jnp.asarray(bits), k=k, nbits=nbits,
                                      interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_bloom_check_ref(jnp.asarray(h1), jnp.asarray(h2),
                                             jnp.asarray(bits), k=k,
                                             nbits=nbits)))
    got = bloom_check_ref(_t(h1), _t(h2), _t(bits), k=k, nbits=nbits)
    np.testing.assert_array_equal(got.numpy(), want)
    got = bloom_ops.might_contain_batch(h1, h2, bits, k=k, nbits=nbits,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_bloom_ops.might_contain_batch(h1, h2, bits, k=k, nbits=nbits))
    assert want[:nadd].all()                      # no false negatives


# ---------------------------------------------------------------- kernel B

@pytest.mark.parametrize("nwords_list,nadd_list,nbits_list,n_miss", [
    ([64, 256, 16], [20, 100, 4], [None] * 3, 25),
    ([2, 128, 2, 1024], [0, 50, 1, 400], [None] * 4, 25),   # empty + tiny
    ([512], [200], [None], 56),              # one cell, Q = 256 exactly
    ([512], [200], [None], 57),              # Q = 257: query padding
    ([8, 40, 64], [10, 60, 90], [200, 1111, 2047], 30),     # wrap shows
    ([64, 64], [0, 0], [None, None], 40),    # every cell empty
])
def test_bloom_check_ragged_matches_jax(nwords_list, nadd_list, nbits_list,
                                        n_miss):
    h1, h2, off, nb, bits = _ragged_case(len(nwords_list) * 7 + n_miss,
                                         nwords_list, nadd_list, nbits_list,
                                         n_miss)
    if any(nbits_list):
        assert _wraps(h1, h2, nb.astype(np.int64), 7)
    args = [jnp.asarray(a) for a in (h1, h2, off, nb, bits)]
    want = np.asarray(jax_bloom_check_ragged(*args, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_bloom_check_ragged_ref(*args)))
    got = bloom_check_ragged_ref(_t(h1), _t(h2), _t(off), _t(nb), _t(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    before = bloom_ops.ragged_dispatch_count
    got = bloom_ops.probe_cells_batch(h1, h2, off, nb, bits, device="cpu")
    assert bloom_ops.ragged_dispatch_count == before + 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_bloom_ops.probe_cells_batch(h1, h2, off, nb, bits))
    if not any(nadd_list):
        assert not got.any()


# ---------------------------------------------------------------- kernel C

@pytest.mark.parametrize("kind,window,max_iters", [
    (1000, 128, 4),
    (20000, 512, 4),
    (50000, 2048, 4),
    (300, 512, 4),              # N < window
    (4096, 800, 4),             # the engine's window, N a power of two
    ("clustered", 128, 2),      # budget exhaustion: idx = -1
    ("equal_prefix", 64, 4),
])
def test_optimistic_lookup_matches_jax(kind, window, max_iters):
    keys, queries = _lookup_case(kind, 11)
    want = [np.asarray(a) for a in jax_optimistic_lookup(
        jnp.asarray(queries), jnp.asarray(keys), window=window,
        max_iters=max_iters, interpret=True)]
    got = optimistic_lookup_ref(_t(queries), _t(keys), window=window,
                                max_iters=max_iters)
    for name, g, w in zip(("idx", "found", "iters"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if kind == "clustered":
        assert (want[0] < 0).any()

    # The ops entry: oracle for the unresolved, equal to the JAX ops entry
    # and to an exact searchsorted.
    before = lookup_ops.lookup_dispatch_count
    idx, found = lookup_ops.lookup_indices_batch(
        queries, keys, window=window, max_iters=max_iters, device="cpu")
    assert lookup_ops.lookup_dispatch_count == before + 1
    jidx, jfound = jax_lookup_ops.lookup_indices_batch(
        queries, keys, window=window, max_iters=max_iters)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(found, jfound)
    exact = np.searchsorted(keys, queries, side="left")
    efound = (exact < len(keys)) & (keys[np.minimum(exact, len(keys) - 1)]
                                    == queries)
    np.testing.assert_array_equal(found, efound)
    np.testing.assert_array_equal(keys[idx[found]], queries[found])


def test_lookup_indices_oracle_fallback_exact():
    """Queries the kernel leaves unresolved take the exact oracle: the op's
    answers equal the JAX oracle's for every query."""
    keys, queries = _lookup_case("clustered", 7)
    idx, _, _ = lookup_ops.lookup(_t(queries), _t(keys), window=128,
                                  max_iters=2)
    assert (idx < 0).any()
    got, found = lookup_ops.lookup_indices(_t(queries), _t(keys), window=128,
                                           max_iters=2)
    ridx, rfound = jax_lookup_oracle(jnp.asarray(queries), jnp.asarray(keys))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))
    hit = np.asarray(rfound)
    np.testing.assert_array_equal(got.numpy()[hit], np.asarray(ridx)[hit])
    oidx, ofound = searchsorted_oracle(_t(queries), _t(keys))
    np.testing.assert_array_equal(oidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(ofound.numpy(), np.asarray(rfound))


def test_probe_cells_batch_rejects_cells_outside_bits():
    """The kernel gathers at off + idx/32 unchecked, so the numpy entry
    refuses any query whose cell does not lie inside the packed bits."""
    u = np.zeros(4, np.uint32)
    bits = np.zeros(8, np.uint32)
    for off, nbits in ((np.int32([0, 0, 0, 7]), np.uint32([64] * 4)),
                       (np.int32([0, 0, 0, -1]), np.uint32([32] * 4)),
                       (np.int32([0] * 4), np.uint32([32, 32, 0, 32]))):
        with pytest.raises(ValueError, match="inside bits"):
            bloom_ops.probe_cells_batch(u, u | 1, off, nbits, bits,
                                        device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel for CUDA tensors and raises for any
    other: it never falls back to the plain version."""
    u = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="card"):
        bloom_kernel.bloom_check_ragged(u, u, torch.zeros(4, dtype=torch.int32),
                                        u, u)
    with pytest.raises(ValueError, match="card"):
        bloom_kernel.bloom_check(u, u, u)
    with pytest.raises(ValueError, match="card"):
        lookup_kernel.optimistic_lookup(u, u)
    with pytest.raises(ValueError, match="card"):
        lookup_kernel.optimistic_lookup_resolve(u, u)
